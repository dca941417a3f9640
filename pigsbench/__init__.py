"""The benchmark of the PyTorch and CUDA port of the PIGS engine
(pathintegralgroundstate_torch): `python3 pigsbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`; see README.md."""
