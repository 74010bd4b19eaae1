// K2 (v_projection.cu) for uint8 raw chunks: the kernel at its eleven tile
// widths, compiled in an nvcc process of its own.

#include "v_projection.cuh"

LMD_VP_DEFINE_DISPATCH(uint8, uint8_t)
