"""Benchmark of raymarchcl_tpu_torch, the PyTorch + CUDA renderer, on
NVIDIA H100 cards.

    python3 -m rmcl_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

renders one cell of BENCHMARK.json (repository root) once: its set-up,
then a closed loop of frames for `--seconds`, then a check of sampled
pixels of the window's frames against the plain reference in
`reference/`. The cells, configurations and metric readers are data found
by name: `workloads/<cell>.json`, `configs/<config>.json`,
`traffic/<traffic>.json`, `metrics/<metric>.py`.
"""
