// Host side of the TMA loads: tensor maps encoded through libcuda's
// cuTensorMapEncodeTiled, fetched from the copy the process has loaded already (the
// kernels' library is linked against the runtime only).

#pragma once

#include <cuda.h>
#include <dlfcn.h>
#include <stdint.h>

namespace tmap {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// bf16 tensor map of `rank` dimensions (innermost first; strides in bytes for all but the
// innermost, which is dense), cut into boxes that land in shared memory with the 128-byte
// swizzle; what lies outside the tensor is zero-filled
inline bool make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the same from the 11 numbers the attention wrappers plan for a [B, T, H, D] tensor
// (ops/flash_attention.py:tensor_map_plan): dims (D, T, H, B), strides in bytes of
// (T, H, B), box (columns, rows, 1, 1)
inline bool make_map_4d(CUtensorMap* map, const void* base, const long long* plan) {
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
  for (int i = 0; i < 4; ++i) dims[i] = (cuuint64_t)plan[i];
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)plan[4 + i];
  for (int i = 0; i < 4; ++i) box[i] = (cuuint32_t)plan[7 + i];
  return make_map(map, base, 4, dims, strides, box);
}

}  // namespace tmap
