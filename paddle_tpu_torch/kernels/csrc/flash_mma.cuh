// Tensor-core fragment helpers shared by the flash-attention kernels: the
// warp-level mma.sync products (bf16 m16n8k16, and TF32 m16n8k8 in the
// 3xTF32 form that keeps float32 accuracy), the TF32 split, ldmatrix,
// cp.async with zero fill, and the tile loader that feeds the shared-memory
// rings.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16" and
// "...m16n8k8"), with g = lane / 4 and t = lane % 4:
//   C/D (16 x 8, f32): c0, c1 at (row g,     cols 2t, 2t+1),
//                      c2, c3 at (row g + 8, cols 2t, 2t+1).
//   bf16 A (16 x 16):  a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                      a3 (g+8, 2t+8..), two bf16 a register, low half first.
//   bf16 B (16 x 8):   b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g).
//   tf32 A (16 x 8):   a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4).
//   tf32 B (8 x 8):    b0 (k t, n g), b1 (k t+4, n g).
// So the C fragments of two neighbouring 8-column tiles are, packed pairwise
// to bf16, the A fragment of a 16-deep bf16 product over those 16 columns:
// a0 = (c0, c1) and a1 = (c2, c3) of the first tile, a2, a3 of the second.
// For TF32 the C fragment of one 8-column tile is an A fragment once the
// product's depth index is permuted: A column t holds column 2t and A column
// t + 4 holds column 2t + 1, so a = (c0, c2, c1, c3), and the B operand is
// read at the same permuted rows (tf32_b_row).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

// ---- products -----------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = big + small, each part a TF32 value (10 explicit mantissa bits,
// rounded to nearest): big carries x's top 11 bits, small the next 11.
struct Tf32Split {
  uint32_t big, small;
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ Tf32Split split_tf32(float x) {
  const uint32_t big = to_tf32(x);
  return {big, to_tf32(x - __uint_as_float(big))};
}

// 3xTF32 A fragment: the four values split once, reused across the B tiles
struct Tf32A {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ Tf32A split_a(float a0, float a1, float a2,
                                         float a3) {
  Tf32A r;
  const float a[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Tf32Split s = split_tf32(a[i]);
    r.big[i] = s.big;
    r.small[i] = s.small;
  }
  return r;
}

// c += a * b in the 3xTF32 form: big*big + big*small + small*big, all into
// the one float32 accumulator; the small*small term (2^-22 relative) is
// dropped. The small terms go first, while the accumulator is smallest.
__device__ __forceinline__ void mma_3xtf32(float c[4], const Tf32A& a,
                                           float b0, float b1) {
  const Tf32Split s0 = split_tf32(b0), s1 = split_tf32(b1);
  const uint32_t b_big[2] = {s0.big, s1.big};
  const uint32_t b_small[2] = {s0.small, s1.small};
  mma_tf32(c, a.small, b_big);
  mma_tf32(c, a.big, b_small);
  mma_tf32(c, a.big, b_big);
}

// The A fragment of a TF32 product from one C fragment (see the top of this
// file): the depth index is permuted so no value moves between lanes.
__device__ __forceinline__ Tf32A c_to_tf32_a(const float c[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// the row, within an 8-deep TF32 step, that B register i (0 or 1) of lane
// quad index t must read under the permutation of c_to_tf32_a
__device__ __forceinline__ int tf32_b_row(int t, int i) { return 2 * t + i; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bf16 A fragment over 16 columns from the C fragments of the two
// 8-column tiles c_lo (columns 0-7) and c_hi (8-15), rounded to bf16.
__device__ __forceinline__ void c_to_bf16_a(uint32_t a[4], const float c_lo[4],
                                            const float c_hi[4]) {
  a[0] = pack_bf16(c_lo[0], c_lo[1]);
  a[1] = pack_bf16(c_lo[2], c_lo[3]);
  a[2] = pack_bf16(c_hi[0], c_hi[1]);
  a[3] = pack_bf16(c_hi[2], c_hi[3]);
}

// 2^x by the special-function unit (ex2.approx.ftz.f32: relative error
// about 2^-22, results below 2^-126 flushed to 0, ex2(0) = 1): the
// softmax's exponentials, in log2 units.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- shared memory ------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i receives matrix i in the mma fragment layout
// (lane l holds row l / 4, columns 2(l % 4), +1). With .trans each
// matrix arrives transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16 bytes from global to shared memory, asynchronously, bypassing L1; with
// `full` false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory row stride, in elements, of a tile of kD columns: padded by
// 16 bytes, which puts the 8 rows an ldmatrix (bf16) or a quad of lanes
// (float32 fragments) reads in 8 different bank groups, and keeps every
// row 16-byte aligned for cp.async.
template <typename T, int kD>
__host__ __device__ constexpr int smem_stride() {
  return kD + 16 / static_cast<int>(sizeof(T));
}

// Whether every row of the [*, D] matrices at `ptrs` is 16-byte aligned,
// so load_tile may copy them with 16-byte cp.async.
template <typename T, typename... P>
inline bool rows_aligned_16(int D, const P*... ptrs) {
  return (D * sizeof(T)) % 16 == 0 &&
         ((reinterpret_cast<uintptr_t>(ptrs) % 16 == 0) && ...);
}

// Stage rows [row0, row0 + kRows) of a [n_rows, D] row-major matrix `src`
// into the [kRows, kD] shared tile `dst` (row stride smem_stride), zero
// beyond n_rows and beyond D. `vec` (every row 16-byte aligned and D a
// multiple of 16 bytes) takes 16-byte cp.async copies, completed by the
// caller's cp_async_wait; otherwise plain loads, complete on return.
template <typename T, int kRows, int kD, int kThreads>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int row0, int n_rows, int D,
                                          bool vec, int tid) {
  constexpr int kStride = smem_stride<T, kD>();
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);  // elements per copy
    constexpr int kChunks = kD / kPer;    // copies per row
    for (int e = tid; e < kRows * kChunks; e += kThreads) {
      const int r = e / kChunks;
      const int c = (e % kChunks) * kPer;
      const bool full = row0 + r < n_rows && c < D;
      const T* from = full ? src + (size_t)(row0 + r) * D + c : src;
      cp_async_16(dst + r * kStride + c, from, full);
    }
  } else {
    for (int e = tid; e < kRows * kD; e += kThreads) {
      const int r = e / kD;
      const int c = e % kD;
      T x;
      if (row0 + r < n_rows && c < D) {
        x = src[(size_t)(row0 + r) * D + c];
      } else {
        x = T(0.f);
      }
      dst[r * kStride + c] = x;
    }
  }
}

// ---- launch -----------------------------------------------------------

// Lets `kernel` launch with `bytes` of dynamic shared memory: above 48 KB a
// kernel must opt in, once per device; `opted` is the caller's record of
// the devices it has opted in on. Returns the opt-in's error code.
constexpr int kMaxDevices = 64;

inline cudaError_t allow_smem(const void* kernel, size_t bytes,
                              bool (&opted)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace flash
