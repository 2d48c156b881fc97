// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++ on the
// tensor cores.
//
// Replaces: the Pallas TPU kernel `_attn_kernel`
// (paddle_tpu/kernels/flash_attention.py:110-181), launched by
// `_flash_forward` (:218-266, pallas_call :241). It computes the same
// function: online-softmax attention with float32 (acc, m, l); causal
// masking at global offsets q_off/k_off; key padding by per-sequence
// lengths (clamped to >= 1); in-kernel attention dropout whose keep-mask is
// the reference's counter hash `_keep_mask` (:65-82), reproduced bit for
// bit, scaling P.V by 1/(1-rate) while the logsumexp stays pre-dropout; P
// rounded to v's dtype before P.V (:163); and a row whose every key is
// masked publishing out = 0 and lse ~= -1e30.
//
// What bounds it on the H100: BERT-base at seq 128 and batch 8 (B*H = 96,
// D = 64, float32, ragged lengths) moves about 12.6 MB (q, k, v, out, lse),
// 3.8 us at 3.35 TB/s, and does 4 * Tq * keys * D = 0.3 GFLOP; the grid is
// 96 x 2 = 192 blocks over 132 SMs, so at that size latency dominates. At
// T = 512 it does 6.4 GFLOP: 0.096 ms at the 67 TFLOP/s float32 rate
// outside the tensor cores, 0.039 ms as 3xTF32 (three TF32 products each,
// 495 TFLOP/s), 0.0065 ms in bf16 (989 TFLOP/s), where the 7.6 us of bytes
// bound it instead.
//
// What the design does about it: one block of 4 warps per (b*h, 64 q
// rows), 16 rows a warp; the TPU's sequential k grid axis is a loop inside
// the block, so Q, the logits and P never touch device memory.
//  - Products on the tensor cores with mma.sync: bf16 m16n8k16 for bf16
//    inputs; for float32, TF32 m16n8k8 in the 3xTF32 form (each operand
//    split into big + small TF32 parts, big*big + big*small + small*big
//    into one float32 accumulator), which keeps float32 accuracy.
//  - Each warp loads its Q fragments once and keeps them in registers
//    (bf16 by ldmatrix; float32 as values, split at use).
//  - K/V tiles of 64 keys pass through a 2-stage ring in dynamic shared
//    memory, filled by 16-byte cp.async copies: the next tile's copy is in
//    flight while the current one is computed. Rows are padded by 16 bytes
//    so the ldmatrix and fragment reads are free of bank conflicts; bf16
//    is staged as bf16.
//  - S = Q.K^T lands in accumulator fragments; scale, masks and the online
//    softmax run on them (row max and sum over a lane quad, in log2 units),
//    with (m, l, acc) in registers. P feeds P.V straight from registers:
//    the C fragments pair up into A fragments (flash_mma.cuh), rounded to
//    bf16 (the reference's cast) or split for 3xTF32.
//  - Dropout runs on the fragments, each element at its (q, k) coordinate,
//    with flash::dropout_keep, so the three kernels draw one mask.
//  - Tiles past the block's key frontier (padding length, causal frontier
//    of its last row) are neither loaded nor computed; the ragged edge of
//    any Tq/Tk and head dims below 32/64/128 are zero-filled in shared
//    memory and masked, so the caller needs no composition branch.
// mma.sync rather than wgmma/TMA: the main path's grid is small (192 blocks
// of 64 rows), and the float32 path splits its operands in registers,
// which wgmma's 32-bit form (both operands K-major in shared memory) would
// not take for V.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using flash::dropout_keep;
using flash::dropout_seed_term;
using flash::key_length;
using flash::kNeg;
using flash::store;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // 128
constexpr int kBlockQ = 16 * kWarps;   // q rows per block, 16 a warp
constexpr int kBlockK = 64;            // keys per K/V tile
constexpr int kStages = 2;             // K/V tiles in the ring
constexpr int kNTiles = kBlockK / 8;   // 8-key column tiles of S
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T, int kD>
constexpr size_t smem_bytes() {
  return (size_t)(kBlockQ + 2 * kStages * kBlockK) *
         flash::smem_stride<T, kD>() * sizeof(T);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, const long long* __restrict__ lens,
                 int H, int Tq, int Tk, int D, int causal, float scale,
                 int dropout, uint32_t keep_thr, float inv_keep,
                 const long long* __restrict__ seed_p, int q_off, int k_off,
                 int vec) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kStride = flash::smem_stride<T, kD>();
  constexpr int kTile = kBlockK * kStride;
  // depth steps of Q.K^T: 16 head dims a step in bf16, 8 in TF32
  constexpr int kQSteps = kBf16 ? kD / 16 : kD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* kv_s = q_s + kBlockQ * kStride;  // stage s: K at 2s, V at 2s + 1

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int t = lane % 4;  // fragment column pair
  const int w_row = warp * 16;
  const T* q_bh = q + (size_t)bh * Tq * D;
  const T* k_bh = k + (size_t)bh * Tk * D;
  const T* v_bh = v + (size_t)bh * Tk * D;

  // Keys at or past kv_lim are padding; the block stops at the last key
  // any of its rows can see. lengths are clamped to >= 1, so an empty
  // sequence attends to key 0 (the reference's rule, flash_attention.py:231)
  const int kv_lim = min(Tk, key_length(lens, bh / H, Tk));
  int kv_end = kv_lim;
  if (causal) {
    const int q_last = min(q0 + kBlockQ, Tq) - 1;
    kv_end = min(kv_end, max(0, q_last + q_off - k_off + 1));
  }
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;

  float acc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  // row max in log2 units (scores times scale * log2 e) and this thread's
  // share of the row sum, for rows g (index 0) and g + 8 (index 1)
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};
  uint32_t qf[kQSteps][4];  // bf16 pairs, or float32 bits
  const uint32_t seed = flash::load_seed(seed_p);
  const uint32_t seed_term = dropout_seed_term(seed, bh);
  const float scale_log2 = scale * kLog2e;

  if (n_tiles > 0) {
    flash::load_tile<T, kBlockQ, kD, kThreads>(q_s, q_bh, q0, Tq, D, vec,
                                                tid);
    flash::load_tile<T, kBlockK, kD, kThreads>(kv_s, k_bh, 0, Tk, D, vec,
                                                tid);
    flash::load_tile<T, kBlockK, kD, kThreads>(kv_s + kTile, v_bh, 0, Tk, D,
                                                vec, tid);
    flash::cp_async_commit();
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBlockK;
    if (it + 1 < n_tiles) {
      // the stage refilled here was read in iteration it - 1
      __syncthreads();
      T* next = kv_s + 2 * ((it + 1) % kStages) * kTile;
      flash::load_tile<T, kBlockK, kD, kThreads>(next, k_bh, k0 + kBlockK,
                                                  Tk, D, vec, tid);
      flash::load_tile<T, kBlockK, kD, kThreads>(next + kTile, v_bh,
                                                  k0 + kBlockK, Tk, D, vec,
                                                  tid);
      flash::cp_async_commit();
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    const T* k_s = kv_s + 2 * (it % kStages) * kTile;
    const T* v_s = k_s + kTile;

    if (it == 0) {
#pragma unroll
      for (int c = 0; c < kQSteps; ++c) {
        if constexpr (kBf16) {
          flash::ldmatrix_x4(qf[c], q_s + (w_row + lane % 16) * kStride +
                                        16 * c + (lane / 16) * 8);
        } else {
          const float* r0 = q_s + (w_row + g) * kStride + 8 * c + t;
          qf[c][0] = __float_as_uint(r0[0]);
          qf[c][1] = __float_as_uint(r0[8 * kStride]);
          qf[c][2] = __float_as_uint(r0[4]);
          qf[c][3] = __float_as_uint(r0[8 * kStride + 4]);
        }
      }
    }

    // S = Q . K^T for the warp's 16 rows and the tile's 64 keys
    float s[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < kQSteps; ++c) {
      if constexpr (kBf16) {
#pragma unroll
        for (int jp = 0; jp < kNTiles / 2; ++jp) {
          uint32_t b[4];
          flash::ldmatrix_x4(
              b, k_s + (16 * jp + lane % 8 + (lane / 16) * 8) * kStride +
                     16 * c + ((lane / 8) % 2) * 8);
          flash::mma_bf16(s[2 * jp], qf[c], b);
          flash::mma_bf16(s[2 * jp + 1], qf[c], b + 2);
        }
      } else {
        const flash::Tf32A a = flash::split_a(
            __uint_as_float(qf[c][0]), __uint_as_float(qf[c][1]),
            __uint_as_float(qf[c][2]), __uint_as_float(qf[c][3]));
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
          const float* kr = k_s + (8 * j + g) * kStride + 8 * c + t;
          flash::mma_3xtf32(s[j], a, kr[0], kr[4]);
        }
      }
    }

    // scale to log2 units and mask: keys past the length or Tk, and under
    // causal keys past the row's frontier; a warp whose rows all see every
    // key of the tile skips the test
    bool need_mask = k0 + kBlockK > kv_lim;
    if (causal) {
      need_mask = need_mask || k0 + kBlockK - 1 + k_off > q0 + w_row + q_off;
    }
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (need_mask) {
          const int kp = k0 + 8 * j + 2 * t + (e & 1);
          const int qp = q0 + w_row + g + 8 * (e >> 1);
          bool valid = kp < kv_lim;
          if (causal) valid = valid && qp + q_off >= kp + k_off;
          x = valid ? x : kNeg;
        }
        s[j][e] = x;
      }
    }

    // online softmax; a row with no valid key yet keeps m = kNeg, where
    // p = exp2(kNeg - kNeg) = 1 is finite and is cancelled by corr = 0 at
    // the row's first valid key, or zeroed at the end
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = flash::exp2_approx(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = flash::exp2_approx(s[j][e] - mx);
          sum += p;
          s[j][e] = p;
        }
      }
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int i = 0; i < kD / 8; ++i) {
        acc[i][2 * r] *= corr;
        acc[i][2 * r + 1] *= corr;
      }
    }
    if (dropout) {
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + 2 * t + (e & 1);
          const int qp = q0 + w_row + g + 8 * (e >> 1);
          s[j][e] = dropout_keep(seed_term, qp, kp, Tk, keep_thr)
                        ? s[j][e] * inv_keep : 0.f;
        }
      }
    }

    // acc += P . V, P from registers: rounded to bf16 (the reference's
    // cast to v's dtype), or split for 3xTF32
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < kNTiles / 2; ++kk) {
        uint32_t a[4];
        flash::c_to_bf16_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < kD / 16; ++dp) {
          uint32_t b[4];
          flash::ldmatrix_x4_trans(
              b, v_s + (16 * kk + lane % 8 + ((lane / 8) % 2) * 8) * kStride +
                     16 * dp + (lane / 16) * 8);
          flash::mma_bf16(acc[2 * dp], a, b);
          flash::mma_bf16(acc[2 * dp + 1], a, b + 2);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const flash::Tf32A a = flash::c_to_tf32_a(s[j]);
        const float* v0 = v_s + (8 * j + flash::tf32_b_row(t, 0)) * kStride + g;
        const float* v1 = v_s + (8 * j + flash::tf32_b_row(t, 1)) * kStride + g;
#pragma unroll
        for (int dt = 0; dt < kD / 8; ++dt) {
          flash::mma_3xtf32_acc<kD <= 64>(acc[dt], a, v0[8 * dt],
                                          v1[8 * dt]);
        }
      }
    }
  }

  // a row with every key masked keeps m at kNeg: publish out = 0 and
  // lse = kNeg + log(1e-30), as the reference's emit step does
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qp = q0 + w_row + g + 8 * r;
    if (qp >= Tq) continue;
    const bool live = m[r] > 0.5f * kNeg;
    const float l_safe = fmaxf(live ? l[r] : 0.f, 1e-30f);
    T* o = out + ((size_t)bh * Tq + qp) * D;
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) {
      const int d = 8 * i + 2 * t;
      if (d < D) store(o + d, live ? acc[i][2 * r] / l_safe : 0.f);
      if (d + 1 < D) store(o + d + 1, live ? acc[i][2 * r + 1] / l_safe : 0.f);
    }
    if (t == 0) {
      lse[(size_t)bh * Tq + qp] =
          live ? (m[r] + log2f(l_safe)) * kLn2 : kNeg + logf(1e-30f);
    }
  }
}

template <typename T, int kD>
cudaError_t launch_d(const T* q, const T* k, const T* v, T* out, float* lse,
                     const long long* lens, int BH, int H, int Tq, int Tk,
                     int D, int causal, float scale, int dropout,
                     uint32_t keep_thr, float inv_keep, const long long* seed,
                     int q_off, int k_off, int vec, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<T, kD>();
  auto kernel = flash_fwd_kernel<T, kD>;
  static bool opted[flash::kMaxDevices] = {};
  const cudaError_t err =
      flash::allow_smem(reinterpret_cast<const void*>(kernel), bytes, opted);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, bytes, stream>>>(q, k, v, out, lse, lens, H, Tq,
                                            Tk, D, causal, scale, dropout,
                                            keep_thr, inv_keep, seed, q_off,
                                            k_off, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, const long long* lens, int BH, int H, int Tq,
                   int Tk, int D, int causal, float scale, int dropout,
                   uint32_t keep_thr, float inv_keep, const long long* seed,
                   int q_off, int k_off, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  const int vec = flash::rows_aligned_16<T>(D, q, k, v);
  if (D <= 32) {
    return launch_d<T, 32>(qp, kp, vp, op, lse, lens, BH, H, Tq, Tk, D,
                           causal, scale, dropout, keep_thr, inv_keep, seed,
                           q_off, k_off, vec, stream);
  } else if (D <= 64) {
    return launch_d<T, 64>(qp, kp, vp, op, lse, lens, BH, H, Tq, Tk, D,
                           causal, scale, dropout, keep_thr, inv_keep, seed,
                           q_off, k_off, vec, stream);
  }
  return launch_d<T, 128>(qp, kp, vp, op, lse, lens, BH, H, Tq, Tk, D,
                          causal, scale, dropout, keep_thr, inv_keep, seed,
                          q_off, k_off, vec, stream);
}

}  // namespace

// q, k, v, out: contiguous [BH, T, D] of dtype (0 = float32, 1 = bfloat16);
// lse: float32 [BH, Tq]; lens: int64 [BH / H] sequence lengths, or null for
// no padding. Launches on `stream` and returns the launch's error code
// (cudaGetLastError(), or the shared-memory opt-in's).
// seed: int64 in device memory, the dropout seed (its low 32 bits), read
// once by each block, or null without dropout.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, float* lse, const long long* lens, int BH,
                         int H, int Tq, int Tk, int D, int causal,
                         float scale, int dropout, unsigned int keep_thr,
                         float inv_keep, const long long* seed, int q_off,
                         int k_off, int dtype, void* stream) {
  if (D < 1 || D > 128 || BH < 1 || Tq < 1 || H < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch<float>(q, k, v, out, lse, lens, BH, H, Tq, Tk, D,
                              causal, scale, dropout, keep_thr, inv_keep,
                              seed, q_off, k_off, s);
  } else if (dtype == 1) {
    return (int)launch<__nv_bfloat16>(q, k, v, out, lse, lens, BH, H, Tq, Tk,
                                      D, causal, scale, dropout, keep_thr,
                                      inv_keep, seed, q_off, k_off, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
