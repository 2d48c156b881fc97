// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces: the Pallas TPU kernel `_attn_kernel`
// (paddle_tpu/kernels/flash_attention.py:110-181), launched by
// `_flash_forward` (:218-266, pallas_call :241). It computes the same
// function: online-softmax attention with float32 (acc, m, l); causal
// masking at global offsets q_off/k_off; key padding by per-sequence
// lengths (clamped to >= 1); in-kernel attention dropout
// whose keep-mask is the reference's counter hash `_keep_mask` (:65-82),
// reproduced bit for bit, scaling P.V by 1/(1-rate) while the logsumexp
// stays pre-dropout; and a row whose every key is masked publishing
// out = 0 and lse ~= -1e30.
//
// What bounds it on the H100: BERT-base at seq 128 and batch 8 (B*H = 96,
// D = 64, float32) reads and writes about 12.6 MB (q, k, v, out, lse) and
// does about 0.4 GFLOP (QK^T and PV). At 3.35 TB/s the bytes take 3.8 us;
// at the 67 TFLOP/s float32 rate outside the tensor cores, which this
// kernel uses, the arithmetic takes 6.0 us; on the tensor cores it would
// be bandwidth-bound. The grid is only 96 x 2 = 192 blocks over 132 SMs,
// so at this size launch and memory latency, not throughput, dominate.
//
// What the simple design does about it: one CUDA block per (b*h, 64-row
// q tile); the TPU's sequential k grid axis becomes a loop inside the
// block, so nothing is carried between blocks and Q, the logits and P
// never touch device memory. Each q row belongs to 4 threads, each
// holding a quarter of the row's q and accumulator in registers (the
// dot products are finished with two warp shuffles); K/V tiles of 32 keys
// are staged in shared memory as float32, read by every row as
// broadcasts. The loop stops at the block's key frontier (padding length,
// causal frontier of its last row), so padded keys are neither loaded nor
// computed. The ragged edge of any Tq/Tk is masked here, so the caller
// needs no composition branch for shapes that do not tile. wgmma/TMA and
// a tensor-core path come later.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::dropout_keep;
using flash::dropout_seed_term;
using flash::key_length;
using flash::kNeg;
using flash::store;
using flash::to_float;

constexpr int kThreadsPerRow = 4;
constexpr int kBlockQ = 64;                          // q rows per block
constexpr int kThreads = kBlockQ * kThreadsPerRow;   // 256
constexpr int kBlockK = 32;                          // keys per K/V tile

template <typename T, int kDMax>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, const long long* __restrict__ lens,
                 int H, int Tq, int Tk, int D, int causal, float scale,
                 int dropout, uint32_t keep_thr, float inv_keep,
                 uint32_t seed, int q_off, int k_off) {
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

  // Keys at or past `length` are padding; the block stops at the last key
  // any of its rows can see (block-uniform, so every thread runs the same
  // number of tiles and the warp shuffles below stay converged).
  // lengths are clamped to >= 1, so an empty sequence attends to key 0
  // (the reference's rule, flash_attention.py:231)
  const int length = key_length(lens, bh / H, Tk);
  int kv_end = min(Tk, length);
  if (causal) {
    const int q_last = min(q0 + kBlockQ, Tq) - 1;
    kv_end = min(kv_end, max(0, q_last + q_off - k_off + 1));
  }

  float q_r[kDPerThread];
  float acc[kDPerThread];
#pragma unroll
  for (int i = 0; i < kDPerThread; ++i) {
    const int d = part + i * kThreadsPerRow;
    q_r[i] = (row_live && d < D) ? to_float(q[q_base + d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNeg;
  float l = 0.f;
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

    float s[kBlockK];
    float m_tile = kNeg;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kDPerThread; ++i) {
        dot += q_r[i] * k_s[j][part + i * kThreadsPerRow];
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kp = k0 + j;
      bool valid = kp < Tk && kp < length;
      if (causal) valid = valid && (q_pos + q_off >= kp + k_off);
      s[j] = valid ? dot * scale : kNeg;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float corr = expf(m - m_new);
    float l_tile = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      s[j] = expf(s[j] - m_new);
      l_tile += s[j];
    }
    l = l * corr + l_tile;
    m = m_new;
#pragma unroll
    for (int i = 0; i < kDPerThread; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float p = s[j];
      if (dropout) {
        p = dropout_keep(seed_term, q_pos, k0 + j, Tk, keep_thr)
                ? p * inv_keep : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kDPerThread; ++i) {
        acc[i] += p * v_s[j][part + i * kThreadsPerRow];
      }
    }
  }

  if (row_live) {
    // a row with every key masked keeps m at kNeg: publish out = 0 and
    // lse = kNeg + log(1e-30), as the reference's emit step does
    const bool live = m > 0.5f * kNeg;
    const float l_safe = fmaxf(live ? l : 0.f, 1e-30f);
#pragma unroll
    for (int i = 0; i < kDPerThread; ++i) {
      const int d = part + i * kThreadsPerRow;
      if (d < D) store(out + q_base + d, live ? acc[i] / l_safe : 0.f);
    }
    if (part == 0) lse[(size_t)bh * Tq + q_pos] = m + logf(l_safe);
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, void* out,
            float* lse, const long long* lens, int BH, int H, int Tq, int Tk,
            int D, int causal, float scale, int dropout, uint32_t keep_thr,
            float inv_keep, uint32_t seed, int q_off, int k_off,
            cudaStream_t stream) {
  const dim3 grid(BH, (Tq + kBlockQ - 1) / kBlockQ);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (D <= 32) {
    flash_fwd_kernel<T, 32><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, op, lse, lens, H, Tq, Tk, D, causal, scale, dropout,
        keep_thr, inv_keep, seed, q_off, k_off);
  } else if (D <= 64) {
    flash_fwd_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, op, lse, lens, H, Tq, Tk, D, causal, scale, dropout,
        keep_thr, inv_keep, seed, q_off, k_off);
  } else {
    flash_fwd_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, op, lse, lens, H, Tq, Tk, D, causal, scale, dropout,
        keep_thr, inv_keep, seed, q_off, k_off);
  }
}

}  // namespace

// q, k, v, out: contiguous [BH, T, D] of dtype (0 = float32, 1 = bfloat16);
// lse: float32 [BH, Tq]; lens: int64 [BH / H] sequence lengths, or null for
// no padding. Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, float* lse, const long long* lens, int BH,
                         int H, int Tq, int Tk, int D, int causal,
                         float scale, int dropout, unsigned int keep_thr,
                         float inv_keep, unsigned int seed, int q_off,
                         int k_off, int dtype, void* stream) {
  if (D < 1 || D > 128 || BH < 1 || Tq < 1 || H < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(q, k, v, out, lse, lens, BH, H, Tq, Tk, D, causal, scale,
                  dropout, keep_thr, inv_keep, seed, q_off, k_off, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(q, k, v, out, lse, lens, BH, H, Tq, Tk, D, causal,
                          scale, dropout, keep_thr, inv_keep, seed, q_off,
                          k_off, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
