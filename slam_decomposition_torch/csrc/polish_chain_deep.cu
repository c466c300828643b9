// The K = 7..12 instances of the polish kernel (polish_chain.cuh); the entry
// points and the K = 1..6 instances are in polish_chain.cu.

#include "polish_chain.cuh"

SLAM_POLISH_DEPTH(, 7)
SLAM_POLISH_DEPTH(, 8)
SLAM_POLISH_DEPTH(, 9)
SLAM_POLISH_DEPTH(, 10)
SLAM_POLISH_DEPTH(, 11)
SLAM_POLISH_DEPTH(, 12)
