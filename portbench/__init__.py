"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one command
runs one cell once, ``python3 portbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``."""
