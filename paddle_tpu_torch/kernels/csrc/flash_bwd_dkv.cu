// Flash-attention backward, dK and dV, for Hopper (sm_90a), hand-written
// CUDA C++.
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
// (B*H = 96, D = 64, float32) reads q, dO, k, v, lse and delta and writes
// dk and dv, about 19 MB, 5.7 us at 3.35 TB/s; it does 8 * Tq * keys * D
// operations (four products per score), 0.8 GFLOP, 12 us at the 67 TFLOP/s
// float32 rate outside the tensor cores, which this kernel uses: bound by
// operations, with a short grid (96 x 4 = 384 blocks) at this size.
//
// What the simple design does about it: one CUDA block per (b*h, 32-key
// tile). The TPU's sequential q grid axis becomes a loop inside the block,
// so dK and dV are carried in registers, nothing is carried between
// blocks, and no atomics are needed (deterministic). Each key row belongs
// to 8 threads, each holding an eighth of its k, v, dk and dv in registers
// (dot products finished with three warp shuffles). Q and dO tiles of 32
// rows, with their lse and delta, are staged in shared memory as float32
// (32 KB at D = 128: static shared memory suffices). A block whose first
// key is already padding has dK = dV = 0 and loads no Q tile. The ragged
// edge of any Tq/Tk is masked here. wgmma/TMA and a tensor-core path come
// later.

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
constexpr int kBlockK = 32;                          // keys per block
constexpr int kThreads = kBlockK * kThreadsPerRow;   // 256
constexpr int kBlockQ = 32;                          // q rows per Q/dO tile

// the sum over the 8 threads of one key row (neighbouring lanes)
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

template <typename T, int kDMax>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, const long long* __restrict__ lens,
                     int H, int Tq, int Tk, int D, int causal, float scale,
                     int dropout, uint32_t keep_thr, float inv_keep,
                     uint32_t seed, int q_off, int k_off) {
  constexpr int kDPerThread = kDMax / kThreadsPerRow;
  __shared__ float q_s[kBlockQ][kDMax];
  __shared__ float do_s[kBlockQ][kDMax];
  __shared__ float lse_s[kBlockQ];
  __shared__ float delta_s[kBlockQ];

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockK;
  const int tid = threadIdx.x;
  const int row = tid / kThreadsPerRow;
  const int part = tid % kThreadsPerRow;
  const int k_pos = k0 + row;
  const bool key_live = k_pos < Tk;
  const size_t k_base = ((size_t)bh * Tk + (key_live ? k_pos : 0)) * D;
  const size_t q_base = (size_t)bh * Tq * D;
  const int length = key_length(lens, bh / H, Tk);

  // the q rows that see a key of this block (block-uniform, so the warp
  // shuffles below stay converged): none when its first key is padding;
  // under causal, from the first row at or past the frontier of key k0
  int q_begin = 0;
  const int q_end = k0 < length ? Tq : 0;
  if (causal) {
    q_begin = min(Tq, max(0, k0 + k_off - q_off));
    q_begin -= q_begin % kBlockQ;
  }

  float k_r[kDPerThread];
  float v_r[kDPerThread];
  float dk_acc[kDPerThread];
  float dv_acc[kDPerThread];
#pragma unroll
  for (int i = 0; i < kDPerThread; ++i) {
    const int d = part + i * kThreadsPerRow;
    const bool in = key_live && d < D && q_begin < q_end;
    k_r[i] = in ? to_float(k[k_base + d]) : 0.f;
    v_r[i] = in ? to_float(v[k_base + d]) : 0.f;
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  const uint32_t seed_term = dropout_seed_term(seed, bh);

  for (int qt = q_begin; qt < q_end; qt += kBlockQ) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kBlockQ * kDMax; e += kThreads) {
      const int r = e / kDMax;
      const int c = e % kDMax;
      const int qp = qt + r;
      float qv = 0.f, dov = 0.f;
      if (qp < Tq && c < D) {
        qv = to_float(q[q_base + (size_t)qp * D + c]);
        dov = to_float(dout[q_base + (size_t)qp * D + c]);
      }
      q_s[r][c] = qv;
      do_s[r][c] = dov;
    }
    if (tid < kBlockQ) {
      // a row past Tq reads as fully masked: p = 0
      const int qp = qt + tid;
      lse_s[tid] = qp < Tq ? lse[(size_t)bh * Tq + qp] : kNeg;
      delta_s[tid] = qp < Tq ? delta[(size_t)bh * Tq + qp] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kBlockQ; ++r) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kDPerThread; ++i) {
        s += q_s[r][part + i * kThreadsPerRow] * k_r[i];
        dp += do_s[r][part + i * kThreadsPerRow] * v_r[i];
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const int qp = qt + r;
      const float lse_q = lse_s[r];
      bool valid = lse_q > 0.5f * kNeg && k_pos < length;
      if (causal) valid = valid && (qp + q_off >= k_pos + k_off);
      const float p = valid ? expf(s * scale - lse_q) : 0.f;
      float p_drop = p;
      if (dropout) {
        const bool keep = dropout_keep(seed_term, qp, k_pos, Tk, keep_thr);
        p_drop = keep ? p * inv_keep : 0.f;
        dp = keep ? dp * inv_keep : 0.f;
      }
      p_drop = round_to<T>(p_drop);
      const float ds = round_to<T>(p * (dp - delta_s[r]) * scale);
#pragma unroll
      for (int i = 0; i < kDPerThread; ++i) {
        dv_acc[i] += p_drop * do_s[r][part + i * kThreadsPerRow];
        dk_acc[i] += ds * q_s[r][part + i * kThreadsPerRow];
      }
    }
  }

  if (key_live) {
#pragma unroll
    for (int i = 0; i < kDPerThread; ++i) {
      const int d = part + i * kThreadsPerRow;
      if (d < D) {
        store(dk + k_base + d, dk_acc[i]);
        store(dv + k_base + d, dv_acc[i]);
      }
    }
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, void* dk, void* dv,
            const long long* lens, int BH, int H, int Tq, int Tk, int D,
            int causal, float scale, int dropout, uint32_t keep_thr,
            float inv_keep, uint32_t seed, int q_off, int k_off,
            cudaStream_t stream) {
  const dim3 grid(BH, (Tk + kBlockK - 1) / kBlockK);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  T* dkp = static_cast<T*>(dk);
  T* dvp = static_cast<T*>(dv);
  if (D <= 32) {
    flash_bwd_dkv_kernel<T, 32><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, dop, lse, delta, dkp, dvp, lens, H, Tq, Tk, D, causal,
        scale, dropout, keep_thr, inv_keep, seed, q_off, k_off);
  } else if (D <= 64) {
    flash_bwd_dkv_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, dop, lse, delta, dkp, dvp, lens, H, Tq, Tk, D, causal,
        scale, dropout, keep_thr, inv_keep, seed, q_off, k_off);
  } else {
    flash_bwd_dkv_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, dop, lse, delta, dkp, dvp, lens, H, Tq, Tk, D, causal,
        scale, dropout, keep_thr, inv_keep, seed, q_off, k_off);
  }
}

}  // namespace

// q, dout: contiguous [BH, Tq, D]; k, v, dk, dv: contiguous [BH, Tk, D];
// all of dtype (0 = float32, 1 = bfloat16). lse, delta: float32 [BH, Tq].
// lens: int64 [BH / H] sequence lengths, or null for no padding. Launches
// on `stream` and returns cudaGetLastError().
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
    launch<float>(q, k, v, dout, lse, delta, dk, dv, lens, BH, H, Tq, Tk, D,
                  causal, scale, dropout, keep_thr, inv_keep, seed, q_off,
                  k_off, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, lens, BH, H, Tq,
                          Tk, D, causal, scale, dropout, keep_thr, inv_keep,
                          seed, q_off, k_off, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* flash_bwd_dkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
