// See cuda_runtime.h: the constants of CUDA's math_constants.h that the
// kernels read.
#pragma once
#include <limits>

#define CUDART_NAN_F std::numeric_limits<float>::quiet_NaN()
#define CUDART_INF_F std::numeric_limits<float>::infinity()
#define CUDART_NAN std::numeric_limits<double>::quiet_NaN()
#define CUDART_INF std::numeric_limits<double>::infinity()
