"""The port's benchmark: ``python3 benchmark/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>`` from the checkout's root."""
