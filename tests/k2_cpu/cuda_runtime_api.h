// See cuda_runtime.h.
#pragma once
#include "cuda_runtime.h"
