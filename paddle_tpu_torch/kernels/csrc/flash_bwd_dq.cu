// Flash-attention backward, dQ, for Hopper (sm_90a), hand-written CUDA C++.
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
//   ds = p * (dp - delta) * scale, rounded to the input dtype (:320);
//   dQ = sum_k ds . K, accumulated in float32, stored in q's dtype.
//
// What bounds it on the H100: BERT-base training at seq 128 and batch 8
// (B*H = 96, D = 64, float32) reads q, dO, k, v, lse and delta and writes
// dq, about 16 MB, 4.7 us at 3.35 TB/s; it does 6 * Tq * keys * D
// operations (three products per score), 0.6 GFLOP, 9.0 us at the
// 67 TFLOP/s float32 rate outside the tensor cores, which this kernel
// uses. So it is bound by operations; at this size the grid of
// 96 x 4 = 384 blocks is short and launch and memory latency count.
//
// What the simple design does about it: one CUDA block per (b*h, 32-row q
// tile). The TPU's sequential k grid axis becomes a loop inside the block,
// so dq is carried in registers, nothing is carried between blocks, and no
// atomics are needed (the result is deterministic). Each q row belongs to
// 8 threads, each holding an eighth of the row's q, dO and dq accumulator
// in registers (dot products finished with three warp shuffles). K/V tiles
// of 32 keys are staged in shared memory as float32 (32 KB at D = 128, so
// static shared memory suffices), read by every row as broadcasts. The loop
// stops at the block's key frontier (padding length, causal frontier of
// its last row), so padded keys are neither loaded nor computed. The
// ragged edge of any Tq/Tk is masked here. wgmma/TMA and a tensor-core
// path come later.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::dropout_keep;
using flash::dropout_seed_term;
using flash::key_length;
using flash::kNeg;
using flash::round_to;
using flash::store;
using flash::to_float;

constexpr int kThreadsPerRow = 8;
constexpr int kBlockQ = 32;                          // q rows per block
constexpr int kThreads = kBlockQ * kThreadsPerRow;   // 256
constexpr int kBlockK = 32;                          // keys per K/V tile

// the sum over the 8 threads of one row (neighbouring lanes)
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

template <typename T, int kDMax>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    const long long* __restrict__ lens, int H, int Tq,
                    int Tk, int D, int causal, float scale, int dropout,
                    uint32_t keep_thr, float inv_keep, uint32_t seed,
                    int q_off, int k_off) {
  constexpr int kDPerThread = kDMax / kThreadsPerRow;
  __shared__ float k_s[kBlockK][kDMax];
  __shared__ float v_s[kBlockK][kDMax];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int row = tid / kThreadsPerRow;
  const int part = tid % kThreadsPerRow;
  const int q_pos = q0 + row;
  const bool row_live = q_pos < Tq;
  const size_t q_base = ((size_t)bh * Tq + (row_live ? q_pos : 0)) * D;
  const size_t kv_base = (size_t)bh * Tk * D;

  // the block stops at the last key any of its rows can see
  // (block-uniform, so the warp shuffles below stay converged)
  const int length = key_length(lens, bh / H, Tk);
  int kv_end = length;
  if (causal) {
    const int q_last = min(q0 + kBlockQ, Tq) - 1;
    kv_end = min(kv_end, max(0, q_last + q_off - k_off + 1));
  }

  float q_r[kDPerThread];
  float do_r[kDPerThread];
  float acc[kDPerThread];
#pragma unroll
  for (int i = 0; i < kDPerThread; ++i) {
    const int d = part + i * kThreadsPerRow;
    const bool in = row_live && d < D;
    q_r[i] = in ? to_float(q[q_base + d]) : 0.f;
    do_r[i] = in ? to_float(dout[q_base + d]) : 0.f;
    acc[i] = 0.f;
  }
  // a row past Tq, or one whose every key is masked (lse ~= -1e30), has
  // p = 0 everywhere and contributes no gradient
  const float lse_r = row_live ? lse[(size_t)bh * Tq + q_pos] : kNeg;
  const float delta_r = row_live ? delta[(size_t)bh * Tq + q_pos] : 0.f;
  const bool row_has_p = lse_r > 0.5f * kNeg;
  const uint32_t seed_term = dropout_seed_term(seed, bh);

  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kBlockK * kDMax; e += kThreads) {
      const int r = e / kDMax;
      const int c = e % kDMax;
      const int kp = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kp < Tk && c < D) {
        kv = to_float(k[kv_base + (size_t)kp * D + c]);
        vv = to_float(v[kv_base + (size_t)kp * D + c]);
      }
      k_s[r][c] = kv;
      v_s[r][c] = vv;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kDPerThread; ++i) {
        s += q_r[i] * k_s[j][part + i * kThreadsPerRow];
        dp += do_r[i] * v_s[j][part + i * kThreadsPerRow];
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const int kp = k0 + j;
      bool valid = row_has_p && kp < length;
      if (causal) valid = valid && (q_pos + q_off >= kp + k_off);
      const float p = valid ? expf(s * scale - lse_r) : 0.f;
      if (dropout) {
        dp = dropout_keep(seed_term, q_pos, kp, Tk, keep_thr) ? dp * inv_keep
                                                              : 0.f;
      }
      const float ds = round_to<T>(p * (dp - delta_r) * scale);
#pragma unroll
      for (int i = 0; i < kDPerThread; ++i) {
        acc[i] += ds * k_s[j][part + i * kThreadsPerRow];
      }
    }
  }

  if (row_live) {
#pragma unroll
    for (int i = 0; i < kDPerThread; ++i) {
      const int d = part + i * kThreadsPerRow;
      if (d < D) store(dq + q_base + d, acc[i]);
    }
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, void* dq,
            const long long* lens, int BH, int H, int Tq, int Tk, int D,
            int causal, float scale, int dropout, uint32_t keep_thr,
            float inv_keep, uint32_t seed, int q_off, int k_off,
            cudaStream_t stream) {
  const dim3 grid(BH, (Tq + kBlockQ - 1) / kBlockQ);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  T* dqp = static_cast<T*>(dq);
  if (D <= 32) {
    flash_bwd_dq_kernel<T, 32><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, dop, lse, delta, dqp, lens, H, Tq, Tk, D, causal, scale,
        dropout, keep_thr, inv_keep, seed, q_off, k_off);
  } else if (D <= 64) {
    flash_bwd_dq_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, dop, lse, delta, dqp, lens, H, Tq, Tk, D, causal, scale,
        dropout, keep_thr, inv_keep, seed, q_off, k_off);
  } else {
    flash_bwd_dq_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, dop, lse, delta, dqp, lens, H, Tq, Tk, D, causal, scale,
        dropout, keep_thr, inv_keep, seed, q_off, k_off);
  }
}

}  // namespace

// q, dout, dq: contiguous [BH, Tq, D]; k, v: contiguous [BH, Tk, D]; all of
// dtype (0 = float32, 1 = bfloat16). lse, delta: float32 [BH, Tq]. lens:
// int64 [BH / H] sequence lengths, or null for no padding. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq,
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
    launch<float>(q, k, v, dout, lse, delta, dq, lens, BH, H, Tq, Tk, D,
                  causal, scale, dropout, keep_thr, inv_keep, seed, q_off,
                  k_off, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, lens, BH, H, Tq, Tk,
                          D, causal, scale, dropout, keep_thr, inv_keep, seed,
                          q_off, k_off, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* flash_bwd_dq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
