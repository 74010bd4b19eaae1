// K2 (v_projection.cu) for bfloat16 raw chunks: the kernel at its eleven tile
// widths, compiled in an nvcc process of its own.

#include "v_projection.cuh"

LMD_VP_DEFINE_DISPATCH(bfloat16, __nv_bfloat16)
