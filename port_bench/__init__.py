"""The port's benchmark: `python3 -m port_bench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`; see run.py and harness.py."""
