// Flash-attention backward, dK and dV, for Hopper (sm_90a), hand-written
// CUDA C++ on the tensor cores.
//
// Replaces: the Pallas TPU kernel `_bwd_dkv_kernel`
// (paddle_tpu/kernels/flash_attention.py:328-407), launched by
// `_flash_backward` (:410-525, pallas_call :496). It computes the same
// function from the forward's saved lse and the precomputed
// delta = rowsum(dO * O) - g_lse:
//   p      = exp(s - lse), 0 where the key is masked (causal at offsets,
//            key padding by lengths clamped to >= 1) and on fully masked
//            rows (lse ~= -1e30, :372-374);
//   p_drop = p kept by the forward's dropout mask and scaled by
//            1/(1-rate), rounded to dO's dtype (:383);
//   dV     = sum_q p_drop^T . dO;
//   dp     = dO . V^T, kept and scaled by the same mask;
//   ds     = p * (dp - delta) * scale, rounded to q's dtype (:392);
//   dK     = sum_q ds^T . Q,
// accumulated in float32 and stored in k's and v's dtype. Q tiles wholly
// before the causal frontier of the block's keys are skipped (:395-400).
//
// What bounds it on the H100: BERT-base training at seq 128 and batch 8
// (B*H = 96, D = 64, float32, ragged lengths) moves about 19 MB (q, dO, k,
// v, lse, delta in; dk, dv out), 5.7 us at 3.35 TB/s, and does
// 8 * Tq * keys * D operations (four products per score), 0.66 GFLOP; its
// grid is 96 x 2 = 192 blocks, so latency counts at that size. At T = 512
// it does 12.9 GFLOP: 0.19 ms at the 67 TFLOP/s float32 rate outside the
// tensor cores, 0.078 ms as 3xTF32 (495 TFLOP/s a product, three
// products), 0.013 ms in bf16 (989 TFLOP/s).
//
// What the design does about it: one block of 4 warps per (b*h, 64 keys),
// 16 keys a warp, in key-major orientation, so dK and dV accumulate in
// registers over the whole q loop: no atomics, deterministic.
//  - Products on the tensor cores with mma.sync: bf16 m16n8k16 for bf16
//    inputs; for float32, TF32 m16n8k8 in the 3xTF32 form (flash_mma.cuh),
//    which keeps float32 accuracy.
//  - K and V are staged once; at bf16 and D <= 64 each warp keeps its K
//    and V fragments in registers for the whole loop, otherwise (float32,
//    or D = 128, where registers would spill) it reads them from shared
//    memory at each tile.
//  - Tiles of Q and dO, with their lse and delta, pass through a 2-stage
//    ring in dynamic shared memory filled by cp.async, so the next tile's
//    copy overlaps the current tile's products; rows are padded by 16 bytes
//    against bank conflicts. A tile is 64 q rows in bf16 up to D = 64 and
//    32 otherwise: the float32 body at 64 rows took 236 registers and ran
//    0.54 ms at T = 512 on an H100, at 32 rows 168 registers and 0.41 ms
//    (tools/torch_flash_variants.py).
//  - Per tile: S^T = K.Q^T and dP^T = V.dO^T land in accumulator
//    fragments; p^T, the dropout keep and scale, and dS^T are computed on
//    them (p is 0, never exp of an overflow, on masked keys and fully
//    masked rows); then dV += p_drop^T.dO and dK += dS^T.Q take p_drop^T
//    and dS^T straight from registers as A operands, rounded to bf16 (the
//    reference's casts) or split for 3xTF32, with Q and dO as B operands
//    from shared memory.
//  - A block whose first key is padding writes zeros and loads nothing;
//    the ragged edge of any Tq/Tk and head dims below 32/64/128 are
//    zero-filled in shared memory and masked.

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
constexpr int kBlockK = 16 * kWarps;   // keys per block, 16 a warp
constexpr int kStages = 2;             // Q/dO tiles in the ring
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int kD>
struct Cfg {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  // q rows per tile: 64 for bf16 up to D = 64, else 32
  static constexpr int kBlockQ = kBf16 && kD <= 64 ? 64 : 32;
  static constexpr bool kKVRegs = kBf16 && kD <= 64;
  static constexpr int kStride = flash::smem_stride<T, kD>();
  static constexpr int kKV = kBlockK * kStride;  // elements of K or V
  static constexpr int kQ = kBlockQ * kStride;   // elements of a Q or dO tile
  // one ring stage: Q, dO, then lse and delta (float32)
  static constexpr size_t kStageBytes =
      2 * kQ * sizeof(T) + 2 * kBlockQ * sizeof(float);
  static constexpr size_t kBytes = 2 * kKV * sizeof(T) + kStages * kStageBytes;
};

// lse and delta of q rows [q0, q0 + n) into shared memory, asynchronously,
// zero past Tq (those rows are masked by position)
template <int kN>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int q0, int Tq, int tid) {
  for (int i = tid; i < kN; i += 32 * kWarps) {
    const bool in = q0 + i < Tq;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     flash::smem_addr(dst + i)),
                 "l"(in ? src + q0 + i : src), "r"(in ? 4 : 0));
  }
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, const long long* __restrict__ lens,
                     int H, int Tq, int Tk, int D, int causal, float scale,
                     int dropout, uint32_t keep_thr, float inv_keep,
                     uint32_t seed, int q_off, int k_off, int vec) {
  using C = Cfg<T, kD>;
  constexpr bool kBf16 = C::kBf16;
  constexpr int kBlockQ = C::kBlockQ;
  constexpr int kStride = C::kStride;
  constexpr int kN = kBlockQ / 8;  // 8-row q column tiles of S^T
  // depth steps over the head dims: 16 a step in bf16, 8 in TF32
  constexpr int kDSteps = kBf16 ? kD / 16 : kD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + C::kKV;
  unsigned char* ring = smem_raw + 2 * C::kKV * sizeof(T);

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockK;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row (and row + 8): keys
  const int t = lane % 4;  // fragment column pair: q rows
  const int w_row = warp * 16;
  const int length = key_length(lens, bh / H, Tk);
  const T* q_bh = q + (size_t)bh * Tq * D;
  const T* do_bh = dout + (size_t)bh * Tq * D;
  const float* lse_bh = lse + (size_t)bh * Tq;
  const float* delta_bh = delta + (size_t)bh * Tq;

  // the q rows that see a key of this block: none when its first key is
  // padding; under causal, from the tile holding the first row at or past
  // the frontier of key k0
  int q_begin = 0;
  const int q_end = k0 < length ? Tq : 0;
  if (causal) {
    q_begin = min(Tq, max(0, k0 + k_off - q_off));
    q_begin -= q_begin % kBlockQ;
  }
  const int n_tiles =
      q_begin < q_end ? (q_end - q_begin + kBlockQ - 1) / kBlockQ : 0;

  float dk_acc[kD / 8][4];
  float dv_acc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  }
  // K and V A fragments (bf16 pairs), when held in registers
  uint32_t kf[C::kKVRegs ? kDSteps : 1][4];
  uint32_t vf[C::kKVRegs ? kDSteps : 1][4];
  const uint32_t seed_term = dropout_seed_term(seed, bh);
  const float scale_log2 = scale * kLog2e;

  auto stage = [&](int i) { return ring + (i % kStages) * C::kStageBytes; };
  auto load_stage = [&](int i, int qt) {
    T* q_t = reinterpret_cast<T*>(stage(i));
    T* do_t = q_t + C::kQ;
    float* rows = reinterpret_cast<float*>(do_t + C::kQ);
    flash::load_tile<T, kBlockQ, kD, kThreads>(q_t, q_bh, qt, Tq, D, vec,
                                                tid);
    flash::load_tile<T, kBlockQ, kD, kThreads>(do_t, do_bh, qt, Tq, D, vec,
                                                tid);
    load_rows<kBlockQ>(rows, lse_bh, qt, Tq, tid);
    load_rows<kBlockQ>(rows + kBlockQ, delta_bh, qt, Tq, tid);
  };

  if (n_tiles > 0) {
    flash::load_tile<T, kBlockK, kD, kThreads>(k_s, k + (size_t)bh * Tk * D,
                                                k0, Tk, D, vec, tid);
    flash::load_tile<T, kBlockK, kD, kThreads>(v_s, v + (size_t)bh * Tk * D,
                                                k0, Tk, D, vec, tid);
    load_stage(0, q_begin);
    flash::cp_async_commit();
  }

  // the A fragment of K or V over head dims [16c, 16c + 16) (bf16)
  auto kv_frag = [&](uint32_t a[4], const T* src, int c) {
    flash::ldmatrix_x4(a, src + (w_row + lane % 16) * kStride + 16 * c +
                              (lane / 16) * 8);
  };
  // the float32 A fragment of K or V over head dims [8c, 8c + 8)
  auto kv_frag_f32 = [&](const T* src, int c) {
    const float* r0 = reinterpret_cast<const float*>(src) +
                      (w_row + g) * kStride + 8 * c + t;
    return flash::split_a(r0[0], r0[8 * kStride], r0[4], r0[8 * kStride + 4]);
  };

  for (int it = 0; it < n_tiles; ++it) {
    const int qt = q_begin + it * kBlockQ;
    if (it + 1 < n_tiles) {
      // the stage refilled here was read in iteration it - 1
      __syncthreads();
      load_stage(it + 1, qt + kBlockQ);
      flash::cp_async_commit();
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    const T* q_t = reinterpret_cast<const T*>(stage(it));
    const T* do_t = q_t + C::kQ;
    const float* lse_t = reinterpret_cast<const float*>(do_t + C::kQ);
    const float* delta_t = lse_t + kBlockQ;

    if constexpr (C::kKVRegs) {
      if (it == 0) {
#pragma unroll
        for (int c = 0; c < kDSteps; ++c) {
          kv_frag(kf[c], k_s, c);
          kv_frag(vf[c], v_s, c);
        }
      }
    }

    // S^T = K . Q^T and dP^T = V . dO^T: the warp's 16 keys by the tile's
    // kBlockQ q rows
    float s[kN][4], dp[kN][4];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < kDSteps; ++c) {
      if constexpr (kBf16) {
        uint32_t ak[4], av[4];
        if constexpr (C::kKVRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ak[i] = kf[c][i];
            av[i] = vf[c][i];
          }
        } else {
          kv_frag(ak, k_s, c);
          kv_frag(av, v_s, c);
        }
#pragma unroll
        for (int jp = 0; jp < kN / 2; ++jp) {
          const int off = (16 * jp + lane % 8 + (lane / 16) * 8) * kStride +
                          16 * c + ((lane / 8) % 2) * 8;
          uint32_t b[4];
          flash::ldmatrix_x4(b, q_t + off);
          flash::mma_bf16(s[2 * jp], ak, b);
          flash::mma_bf16(s[2 * jp + 1], ak, b + 2);
          flash::ldmatrix_x4(b, do_t + off);
          flash::mma_bf16(dp[2 * jp], av, b);
          flash::mma_bf16(dp[2 * jp + 1], av, b + 2);
        }
      } else {
        const flash::Tf32A ak = kv_frag_f32(k_s, c);
        const flash::Tf32A av = kv_frag_f32(v_s, c);
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const int off = (8 * j + g) * kStride + 8 * c + t;
          flash::mma_3xtf32(s[j], ak, q_t[off], q_t[off + 4]);
          flash::mma_3xtf32(dp[j], av, do_t[off], do_t[off + 4]);
        }
      }
    }

    // p^T, p_drop^T (into s) and dS^T (into dp), element by element: rows
    // are keys (g, g + 8), columns q rows (2t, 2t + 1 of each tile)
#pragma unroll
    for (int j = 0; j < kN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const int qp = qt + col;
        const int kp = k0 + w_row + g + 8 * (e >> 1);
        const float lse_q = lse_t[col];
        bool valid = qp < Tq && kp < length && lse_q > 0.5f * kNeg;
        if (causal) valid = valid && qp + q_off >= kp + k_off;
        // the select, not a product, keeps exp of an overflow out
        const float p = valid ? flash::exp2_approx(
                                    fmaf(s[j][e], scale_log2, -lse_q * kLog2e))
                              : 0.f;
        float p_drop = p;
        float dpv = dp[j][e];
        if (dropout) {
          const bool keep = dropout_keep(seed_term, qp, kp, Tk, keep_thr);
          p_drop = keep ? p * inv_keep : 0.f;
          dpv = keep ? dpv * inv_keep : 0.f;
        }
        s[j][e] = p_drop;
        dp[j][e] = p * (dpv - delta_t[col]) * scale;
      }
    }

    // dV += p_drop^T . dO and dK += dS^T . Q, the A operands from
    // registers (rounded to bf16, or split for 3xTF32)
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < kN / 2; ++kk) {
        uint32_t ap[4], as[4];
        flash::c_to_bf16_a(ap, s[2 * kk], s[2 * kk + 1]);
        flash::c_to_bf16_a(as, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dd = 0; dd < kD / 16; ++dd) {
          const int off =
              (16 * kk + lane % 8 + ((lane / 8) % 2) * 8) * kStride +
              16 * dd + (lane / 16) * 8;
          uint32_t b[4];
          flash::ldmatrix_x4_trans(b, do_t + off);
          flash::mma_bf16(dv_acc[2 * dd], ap, b);
          flash::mma_bf16(dv_acc[2 * dd + 1], ap, b + 2);
          flash::ldmatrix_x4_trans(b, q_t + off);
          flash::mma_bf16(dk_acc[2 * dd], as, b);
          flash::mma_bf16(dk_acc[2 * dd + 1], as, b + 2);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const flash::Tf32A ap = flash::c_to_tf32_a(s[j]);
        const flash::Tf32A as = flash::c_to_tf32_a(dp[j]);
        const int r0 = (8 * j + flash::tf32_b_row(t, 0)) * kStride + g;
        const int r1 = (8 * j + flash::tf32_b_row(t, 1)) * kStride + g;
#pragma unroll
        for (int dt = 0; dt < kD / 8; ++dt) {
          flash::mma_3xtf32(dv_acc[dt], ap, do_t[r0 + 8 * dt],
                            do_t[r1 + 8 * dt]);
          flash::mma_3xtf32(dk_acc[dt], as, q_t[r0 + 8 * dt],
                            q_t[r1 + 8 * dt]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = k0 + w_row + g + 8 * r;
    if (kp >= Tk) continue;
    const size_t base = ((size_t)bh * Tk + kp) * D;
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * i + 2 * t + e;
        if (d < D) {
          store(dk + base + d, dk_acc[i][2 * r + e]);
          store(dv + base + d, dv_acc[i][2 * r + e]);
        }
      }
    }
  }
}

template <typename T, int kD>
cudaError_t launch_d(const T* q, const T* k, const T* v, const T* dout,
                     const float* lse, const float* delta, T* dk, T* dv,
                     const long long* lens, int BH, int H, int Tq, int Tk,
                     int D, int causal, float scale, int dropout,
                     uint32_t keep_thr, float inv_keep, uint32_t seed,
                     int q_off, int k_off, int vec, cudaStream_t stream) {
  constexpr size_t bytes = Cfg<T, kD>::kBytes;
  auto kernel = flash_bwd_dkv_kernel<T, kD>;
  static bool opted[flash::kMaxDevices] = {};
  const cudaError_t err =
      flash::allow_smem(reinterpret_cast<const void*>(kernel), bytes, opted);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Tk + kBlockK - 1) / kBlockK);
  kernel<<<grid, kThreads, bytes, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, lens, H, Tq, Tk, D, causal, scale,
      dropout, keep_thr, inv_keep, seed, q_off, k_off, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, const long long* lens, int BH, int H,
                   int Tq, int Tk, int D, int causal, float scale,
                   int dropout, uint32_t keep_thr, float inv_keep,
                   uint32_t seed, int q_off, int k_off, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  T* dkp = static_cast<T*>(dk);
  T* dvp = static_cast<T*>(dv);
  const int vec = flash::rows_aligned_16<T>(D, q, k, v, dout);
  if (D <= 32) {
    return launch_d<T, 32>(qp, kp, vp, dop, lse, delta, dkp, dvp, lens, BH,
                           H, Tq, Tk, D, causal, scale, dropout, keep_thr,
                           inv_keep, seed, q_off, k_off, vec, stream);
  } else if (D <= 64) {
    return launch_d<T, 64>(qp, kp, vp, dop, lse, delta, dkp, dvp, lens, BH,
                           H, Tq, Tk, D, causal, scale, dropout, keep_thr,
                           inv_keep, seed, q_off, k_off, vec, stream);
  }
  return launch_d<T, 128>(qp, kp, vp, dop, lse, delta, dkp, dvp, lens, BH, H,
                          Tq, Tk, D, causal, scale, dropout, keep_thr,
                          inv_keep, seed, q_off, k_off, vec, stream);
}

}  // namespace

// q, dout: contiguous [BH, Tq, D]; k, v, dk, dv: contiguous [BH, Tk, D];
// all of dtype (0 = float32, 1 = bfloat16). lse, delta: float32 [BH, Tq].
// lens: int64 [BH / H] sequence lengths, or null for no padding. Launches
// on `stream` and returns the launch's error code (cudaGetLastError(), or
// the shared-memory opt-in's).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv,
                             const long long* lens, int BH, int H, int Tq,
                             int Tk, int D, int causal, float scale,
                             int dropout, unsigned int keep_thr,
                             float inv_keep, unsigned int seed, int q_off,
                             int k_off, int dtype, void* stream) {
  if (D < 1 || D > 128 || BH < 1 || Tq < 1 || Tk < 1 || H < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch<float>(q, k, v, dout, lse, delta, dk, dv, lens, BH, H,
                              Tq, Tk, D, causal, scale, dropout, keep_thr,
                              inv_keep, seed, q_off, k_off, s);
  } else if (dtype == 1) {
    return (int)launch<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv,
                                      lens, BH, H, Tq, Tk, D, causal, scale,
                                      dropout, keep_thr, inv_keep, seed,
                                      q_off, k_off, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_bwd_dkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
