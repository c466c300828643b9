"""The A/B driver of chip_smoke.py runs (no card needed for these)."""

from slam_decomposition_torch.tools import ab_smoke

OUTPUT = """\
NVIDIA H100 80GB HBM3, 700.00 W
[device] torch 2.11.0+cu128 cuda 12.8: NVIDIA H100 80GB HBM3 (count 1)
[build] 40.1 s nvcc -> libslam_chain_0123456789abcdef.so
[build] ptxas lm_chain_kernel<2>: 96 registers, 0 B stack, 0 B spill stores, 0 B spill loads
[parity] lm_chain k=2 L=40000: max|d||r||^2| 1.2e-02, 0.99860 of lanes within rtol 0.001 atol 1e-05 \
(need >= 0.99); kernel 3.183 ms, plain 248.000 ms
[bound] lm_chain k=2: 5.326 of 8 iterations per lane rebuild J
[main] NVIDIA H100 80GB HBM3, 700.00 W: ranges 0.086 s, solve 0.097 s, rescue 0.027 s, total 0.210 s
[transpile] qft(64): 2048 blocks, sqiswap counts {0: 741, 2: 1275, 3: 32}
[transpile] NVIDIA H100 80GB HBM3, 700.00 W: qft(64) pass_manager_basic warm 0.941 s batched vs 8.138 s host loop
[api] NVIDIA H100 80GB HBM3, 700.00 W: k=2 0.196 s, k=3 0.178 s, call 0.392 s -> 255117.9 targets/s
{"ok": true}
"""


def test_summary_keeps_the_lines_to_compare():
    got = ab_smoke.summary(OUTPUT)
    assert got == [
        "NVIDIA H100 80GB HBM3, 700.00 W",
        "[build] ptxas lm_chain_kernel<2>: 96 registers, 0 B stack, 0 B spill stores, 0 B spill loads",
        "[parity] lm_chain k=2 L=40000: kernel 3.183 ms, plain 248.000 ms",
        "[bound] lm_chain k=2: 5.326 of 8 iterations per lane rebuild J",
        "[main] NVIDIA H100 80GB HBM3, 700.00 W: ranges 0.086 s, solve 0.097 s, rescue 0.027 s, total 0.210 s",
        "[transpile] NVIDIA H100 80GB HBM3, 700.00 W: qft(64) pass_manager_basic warm 0.941 s batched vs "
        "8.138 s host loop",
        "[api] NVIDIA H100 80GB HBM3, 700.00 W: k=2 0.196 s, k=3 0.178 s, call 0.392 s -> 255117.9 targets/s",
    ]


def test_refuses_a_tree_without_chip_smoke(tmp_path):
    assert ab_smoke.main([str(tmp_path)]) == 2
    assert ab_smoke.main([]) == 2
