// Flash-attention backward, dQ, for Hopper (sm_90a), hand-written CUDA C++
// on the tensor cores.
//
// Replaces: the Pallas TPU kernel `_bwd_dq_kernel`
// (paddle_tpu/kernels/flash_attention.py:269-325), launched by
// `_flash_backward` (:410-525, pallas_call :450). It computes the same
// function from the forward's saved lse and the precomputed
// delta = rowsum(dO * O) - g_lse:
//   p  = exp(s - lse), 0 where the key is masked (causal at offsets
//        q_off/k_off, key padding by lengths clamped to >= 1) and on a row
//        whose every key is masked (lse ~= -1e30, :309-311);
//   dp = dO . V^T, kept by the forward's dropout mask and scaled by
//        1/(1-rate) (the hash of flash_common.cuh, bit for bit);
//   ds = p * (dp - delta) * scale, rounded to k's dtype (:320);
//   dQ = sum_k ds . K, accumulated in float32, stored in q's dtype.
//
// What bounds it on the H100: three products per (q row, valid key) pair,
// 6 * Tq * keys * D operations, against q, dO, dq, the k/v rows below each
// length, lse and delta. BERT-base training at seq 128 and batch 8
// (B*H = 96, D = 64, float32, ragged lengths) moves 14.7 MB, 4.4 us at
// 3.35 TB/s, for 0.50 GFLOP, 3.0 us as 3xTF32 (three TF32 products each,
// 165 TFLOP/s): bytes bound it, and its grid of 96 x 2 = 192 blocks makes
// latency count. At T = 512 it does 9.7 GFLOP: float32 moves 63 MB
// (0.019 ms) and is bound by the 3xTF32 products (0.059 ms); bf16 moves
// 32 MB (0.0095 ms) and the products take 0.0098 ms at 989 TFLOP/s.
//
// What the design does about it: the forward's orientation. One block of
// 4 warps per (b*h, 64 q rows), 16 rows a warp; the TPU's sequential k
// grid axis is a loop inside the block, so the dq sum stays in accumulator
// fragments: no atomics, nothing carried between blocks, deterministic.
//  - Products on the tensor cores with mma.sync: bf16 m16n8k16 for bf16
//    inputs; for float32, TF32 m16n8k8 in the 3xTF32 form (flash_mma.cuh),
//    which keeps float32 accuracy.
//  - Q and dO are staged once in shared memory, and each warp reads its A
//    fragments of them at every tile (ldmatrix in bf16; float32 values,
//    split at use). Holding the bf16 fragments in registers for the whole
//    loop instead ran 2 % slower at T = 512 on an H100
//    (tools/torch_flash_variants.py, dq_bf16_frags_regs).
//  - K/V tiles pass through a 2-stage ring in dynamic shared memory,
//    filled by 16-byte cp.async copies, so the next tile's copy overlaps
//    the current tile's products; rows are padded by 16 bytes against bank
//    conflicts. A tile is 64 keys in bf16 and 32 in float32, where the
//    3xTF32 split makes registers scarce.
//  - Per tile: S = Q.K^T and dP = dO.V^T land in accumulator fragments;
//    p, the dropout keep and scale, and dS are computed on them (p is 0,
//    never exp of an overflow, on masked keys, fully masked rows and rows
//    past Tq); then dQ += dS.K takes dS straight from registers as the A
//    operand, rounded to bf16 (the reference's cast) or split for 3xTF32,
//    with K as the B operand read from the ring (ldmatrix.trans in bf16).
//  - The key loop stops at the block's frontier (padding length, causal
//    frontier of its last row), and masks are evaluated only on tiles that
//    cross a frontier; a block with no visible key writes zeros. The ragged
//    edge of any Tq/Tk and head dims below 32/64/128 are zero-filled in
//    shared memory and masked.

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

constexpr int kStages = 2;  // K/V tiles in the ring
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int kD>
struct Cfg {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBlockQ = 16 * kWarps;  // q rows per block
  // keys per K/V tile: 64 in bf16, 32 in float32
  static constexpr int kBlockK = kBf16 ? 64 : 32;
  static constexpr int kStride = flash::smem_stride<T, kD>();
  static constexpr int kQ = kBlockQ * kStride;   // elements of Q or dO
  static constexpr int kKV = kBlockK * kStride;  // elements of a K or V tile
  static constexpr size_t kBytes = (2 * kQ + 2 * kStages * kKV) * sizeof(T);
};

template <typename T, int kD>
__global__ void __launch_bounds__(Cfg<T, kD>::kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    const long long* __restrict__ lens, int H, int Tq,
                    int Tk, int D, int causal, float scale, int dropout,
                    uint32_t keep_thr, float inv_keep,
                    const long long* __restrict__ seed_p,
                    int q_off, int k_off, int vec) {
  using C = Cfg<T, kD>;
  constexpr bool kBf16 = C::kBf16;
  constexpr int kThreads = C::kThreads;
  constexpr int kBlockQ = C::kBlockQ;
  constexpr int kBlockK = C::kBlockK;
  constexpr int kStride = C::kStride;
  constexpr int kNTiles = kBlockK / 8;  // 8-key column tiles of S and dP
  // depth steps over the head dims: 16 a step in bf16, 8 in TF32
  constexpr int kDSteps = kBf16 ? kD / 16 : kD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* do_s = q_s + C::kQ;
  T* kv_s = do_s + C::kQ;  // stage s: K at 2s, V at 2s + 1

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row (and row + 8): q rows
  const int t = lane % 4;  // fragment column pair: keys, or head dims
  const int w_row = warp * 16;
  const T* k_bh = k + (size_t)bh * Tk * D;
  const T* v_bh = v + (size_t)bh * Tk * D;

  // Keys at or past kv_lim are padding; the block stops at the last key
  // any of its rows can see
  const int kv_lim = key_length(lens, bh / H, Tk);
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
  // rows g (index 0) and g + 8 (index 1): lse in log2 units and delta; a
  // row past Tq, or one whose every key is masked (lse ~= -1e30), is not
  // live and has p = 0 everywhere
  float lse_log2[2], delta_r[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + w_row + g + 8 * r;
    const float l = qp < Tq ? lse[(size_t)bh * Tq + qp] : kNeg;
    live[r] = l > 0.5f * kNeg;
    lse_log2[r] = l * kLog2e;
    delta_r[r] = qp < Tq ? delta[(size_t)bh * Tq + qp] : 0.f;
  }
  const uint32_t seed = flash::load_seed(seed_p);
  const uint32_t seed_term = dropout_seed_term(seed, bh);
  const float scale_log2 = scale * kLog2e;

  if (n_tiles > 0) {
    flash::load_tile<T, kBlockQ, kD, kThreads>(q_s, q + (size_t)bh * Tq * D,
                                                q0, Tq, D, vec, tid);
    flash::load_tile<T, kBlockQ, kD, kThreads>(
        do_s, dout + (size_t)bh * Tq * D, q0, Tq, D, vec, tid);
    flash::load_tile<T, kBlockK, kD, kThreads>(kv_s, k_bh, 0, Tk, D, vec,
                                                tid);
    flash::load_tile<T, kBlockK, kD, kThreads>(kv_s + C::kKV, v_bh, 0, Tk, D,
                                                vec, tid);
    flash::cp_async_commit();
  }

  // the A fragment of Q or dO over head dims [16c, 16c + 16) (bf16)
  auto frag = [&](uint32_t a[4], const T* src, int c) {
    flash::ldmatrix_x4(a, src + (w_row + lane % 16) * kStride + 16 * c +
                              (lane / 16) * 8);
  };
  // the float32 A fragment of Q or dO over head dims [8c, 8c + 8), split
  auto frag_f32 = [&](const T* src, int c) {
    const float* r0 = reinterpret_cast<const float*>(src) +
                      (w_row + g) * kStride + 8 * c + t;
    return flash::split_a(r0[0], r0[8 * kStride], r0[4], r0[8 * kStride + 4]);
  };

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBlockK;
    if (it + 1 < n_tiles) {
      // the stage refilled here was read in iteration it - 1
      __syncthreads();
      T* next = kv_s + 2 * ((it + 1) % kStages) * C::kKV;
      flash::load_tile<T, kBlockK, kD, kThreads>(next, k_bh, k0 + kBlockK,
                                                  Tk, D, vec, tid);
      flash::load_tile<T, kBlockK, kD, kThreads>(next + C::kKV, v_bh,
                                                  k0 + kBlockK, Tk, D, vec,
                                                  tid);
      flash::cp_async_commit();
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    const T* k_s = kv_s + 2 * (it % kStages) * C::kKV;
    const T* v_s = k_s + C::kKV;

    // S = Q . K^T and dP = dO . V^T for the warp's 16 rows and the tile's
    // kBlockK keys
    float s[kNTiles][4], dp[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < kDSteps; ++c) {
      if constexpr (kBf16) {
        uint32_t aq[4], ado[4];
        frag(aq, q_s, c);
        frag(ado, do_s, c);
#pragma unroll
        for (int jp = 0; jp < kNTiles / 2; ++jp) {
          const int off = (16 * jp + lane % 8 + (lane / 16) * 8) * kStride +
                          16 * c + ((lane / 8) % 2) * 8;
          uint32_t b[4];
          flash::ldmatrix_x4(b, k_s + off);
          flash::mma_bf16(s[2 * jp], aq, b);
          flash::mma_bf16(s[2 * jp + 1], aq, b + 2);
          flash::ldmatrix_x4(b, v_s + off);
          flash::mma_bf16(dp[2 * jp], ado, b);
          flash::mma_bf16(dp[2 * jp + 1], ado, b + 2);
        }
      } else {
        const flash::Tf32A aq = frag_f32(q_s, c);
        const flash::Tf32A ado = frag_f32(do_s, c);
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
          const int off = (8 * j + g) * kStride + 8 * c + t;
          flash::mma_3xtf32(s[j], aq, k_s[off], k_s[off + 4]);
          flash::mma_3xtf32_acc<kD <= 64>(dp[j], ado, v_s[off],
                                          v_s[off + 4]);
        }
      }
    }

    // p and dS (into dp), element by element: rows are q rows (g, g + 8),
    // columns keys (2t, 2t + 1 of each tile). The key masks are evaluated
    // only on a tile that crosses the length or the warp's causal frontier
    bool need_mask = k0 + kBlockK > kv_lim;
    if (causal) {
      need_mask = need_mask || k0 + kBlockK - 1 + k_off > q0 + w_row + q_off;
    }
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kp = k0 + 8 * j + 2 * t + (e & 1);
        const int qp = q0 + w_row + g + 8 * r;
        bool valid = live[r];
        if (need_mask) {
          valid = valid && kp < kv_lim;
          if (causal) valid = valid && qp + q_off >= kp + k_off;
        }
        // the select, not a product, keeps exp of an overflow out
        const float p = valid ? flash::exp2_approx(fmaf(
                                    s[j][e], scale_log2, -lse_log2[r]))
                              : 0.f;
        float dpv = dp[j][e];
        if (dropout) {
          dpv = dropout_keep(seed_term, qp, kp, Tk, keep_thr) ? dpv * inv_keep
                                                              : 0.f;
        }
        dp[j][e] = p * (dpv - delta_r[r]) * scale;
      }
    }

    // dQ += dS . K, dS from registers (rounded to bf16, or split for
    // 3xTF32), K as the B operand from the ring
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < kNTiles / 2; ++kk) {
        uint32_t a[4];
        flash::c_to_bf16_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dd = 0; dd < kD / 16; ++dd) {
          uint32_t b[4];
          flash::ldmatrix_x4_trans(
              b, k_s + (16 * kk + lane % 8 + ((lane / 8) % 2) * 8) * kStride +
                     16 * dd + (lane / 16) * 8);
          flash::mma_bf16(acc[2 * dd], a, b);
          flash::mma_bf16(acc[2 * dd + 1], a, b + 2);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const flash::Tf32A a = flash::c_to_tf32_a(dp[j]);
        const T* k0r = k_s + (8 * j + flash::tf32_b_row(t, 0)) * kStride + g;
        const T* k1r = k_s + (8 * j + flash::tf32_b_row(t, 1)) * kStride + g;
#pragma unroll
        for (int dt = 0; dt < kD / 8; ++dt) {
          flash::mma_3xtf32_acc<kD <= 64>(acc[dt], a, k0r[8 * dt],
                                          k1r[8 * dt]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + w_row + g + 8 * r;
    if (qp >= Tq) continue;
    T* o = dq + ((size_t)bh * Tq + qp) * D;
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) {
      const int d = 8 * i + 2 * t;
      if (d < D) store(o + d, acc[i][2 * r]);
      if (d + 1 < D) store(o + d + 1, acc[i][2 * r + 1]);
    }
  }
}

template <typename T, int kD>
cudaError_t launch_d(const T* q, const T* k, const T* v, const T* dout,
                     const float* lse, const float* delta, T* dq,
                     const long long* lens, int BH, int H, int Tq, int Tk,
                     int D, int causal, float scale, int dropout,
                     uint32_t keep_thr, float inv_keep, const long long* seed,
                     int q_off, int k_off, int vec, cudaStream_t stream) {
  using C = Cfg<T, kD>;
  auto kernel = flash_bwd_dq_kernel<T, kD>;
  static bool opted[flash::kMaxDevices] = {};
  const cudaError_t err = flash::allow_smem(
      reinterpret_cast<const void*>(kernel), C::kBytes, opted);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tq + C::kBlockQ - 1) / C::kBlockQ);
  kernel<<<grid, C::kThreads, C::kBytes, stream>>>(
      q, k, v, dout, lse, delta, dq, lens, H, Tq, Tk, D, causal, scale,
      dropout, keep_thr, inv_keep, seed, q_off, k_off, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, const long long* lens, int BH, int H, int Tq,
                   int Tk, int D, int causal, float scale, int dropout,
                   uint32_t keep_thr, float inv_keep, const long long* seed,
                   int q_off, int k_off, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  T* dqp = static_cast<T*>(dq);
  const int vec = flash::rows_aligned_16<T>(D, q, k, v, dout);
  if (D <= 32) {
    return launch_d<T, 32>(qp, kp, vp, dop, lse, delta, dqp, lens, BH, H, Tq,
                           Tk, D, causal, scale, dropout, keep_thr, inv_keep,
                           seed, q_off, k_off, vec, stream);
  } else if (D <= 64) {
    return launch_d<T, 64>(qp, kp, vp, dop, lse, delta, dqp, lens, BH, H, Tq,
                           Tk, D, causal, scale, dropout, keep_thr, inv_keep,
                           seed, q_off, k_off, vec, stream);
  }
  return launch_d<T, 128>(qp, kp, vp, dop, lse, delta, dqp, lens, BH, H, Tq,
                          Tk, D, causal, scale, dropout, keep_thr, inv_keep,
                          seed, q_off, k_off, vec, stream);
}

}  // namespace

// q, dout, dq: contiguous [BH, Tq, D]; k, v: contiguous [BH, Tk, D]; all of
// dtype (0 = float32, 1 = bfloat16). lse, delta: float32 [BH, Tq]. lens:
// int64 [BH / H] sequence lengths, or null for no padding. Launches on
// `stream` and returns the launch's error code (cudaGetLastError(), or the
// shared-memory opt-in's).
// seed: int64 in device memory, the dropout seed (its low 32 bits), read
// once by each block, or null without dropout.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq,
                            const long long* lens, int BH, int H, int Tq,
                            int Tk, int D, int causal, float scale,
                            int dropout, unsigned int keep_thr,
                            float inv_keep, const long long* seed, int q_off,
                            int k_off, int dtype, void* stream) {
  if (D < 1 || D > 128 || BH < 1 || Tq < 1 || Tk < 1 || H < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch<float>(q, k, v, dout, lse, delta, dq, lens, BH, H, Tq,
                              Tk, D, causal, scale, dropout, keep_thr,
                              inv_keep, seed, q_off, k_off, s);
  } else if (dtype == 1) {
    return (int)launch<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, lens,
                                      BH, H, Tq, Tk, D, causal, scale,
                                      dropout, keep_thr, inv_keep, seed,
                                      q_off, k_off, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_bwd_dq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
