// K2 (v_projection.cu) for float16 raw chunks: the kernel at its eleven tile
// widths, compiled in an nvcc process of its own.

#include "v_projection.cuh"

LMD_VP_DEFINE_DISPATCH(float16, __half)
