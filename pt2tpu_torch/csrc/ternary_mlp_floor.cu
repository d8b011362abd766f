// K2's floor probe on the CUDA cores (impl="floor8"): the FLOOR instances of
// csrc/ternary_mlp.cu's kernel and its C entry pt2_ternary_mlp_floor, built as
// a library of their own so that they compile beside the bf16 instances, in
// parallel (csrc/ternary_mlp.cu's header says what the floor computes).
#define PT2_MLP_FLOOR
#include "ternary_mlp.cu"
