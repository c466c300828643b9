// The K = 7..12 instances of the Adam kernel (adam_chain.cuh); the entry
// points and the K = 1..6 instances are in adam_chain.cu.

#include "adam_chain.cuh"

SLAM_ADAM_DEPTH(, 7)
SLAM_ADAM_DEPTH(, 8)
SLAM_ADAM_DEPTH(, 9)
SLAM_ADAM_DEPTH(, 10)
SLAM_ADAM_DEPTH(, 11)
SLAM_ADAM_DEPTH(, 12)
