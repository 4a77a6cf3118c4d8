"""The benchmark of the PyTorch/CUDA port (`repro_torch`): one command runs one
cell once (`python portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`). Configurations, traffic mixes, metric readers, references and
limits are files found by name; `BENCHMARK.json` at the repository root lists
the cells."""
