"""The port's benchmark: ``python3 benchmark/run.py --workload <cell> ...``."""
