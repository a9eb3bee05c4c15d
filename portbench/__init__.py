"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one run
of one cell a process, ``python3 portbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` from the repository's root."""
