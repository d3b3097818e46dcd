// The generic flash and paged prefill kernel for bf16 operands (design and
// C interface in attention_wg.cuh; attention_wg16.cu holds fp16's).
#define ATTENTION_WG_ELT __nv_bfloat16
#define ATTENTION_WG_DT 1
#include "attention_wg.cuh"
