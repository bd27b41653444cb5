"""The port's benchmark: ``python3 gpubench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. See README.md."""
