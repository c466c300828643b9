// The K = 7..12 instances of the f32 LM kernel (lm_chain.cuh); the entry
// points and the K = 1..6 instances are in lm_chain.cu.

#include "lm_chain.cuh"

SLAM_LM_DEPTH(, 7)
SLAM_LM_DEPTH(, 8)
SLAM_LM_DEPTH(, 9)
SLAM_LM_DEPTH(, 10)
SLAM_LM_DEPTH(, 11)
SLAM_LM_DEPTH(, 12)
