// The generic flash and paged prefill kernel for fp16 operands (design and
// C interface in attention_wg.cuh; attention_wg.cu holds bf16's).
#define ATTENTION_WG_ELT __half
#define ATTENTION_WG_DT 2
#include "attention_wg.cuh"
