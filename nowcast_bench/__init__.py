"""The benchmark of the PyTorch/CUDA port's Path-B serving
(``weatherforecastingtoolkit_tpu_torch``): one cell a run,
``python3 nowcast_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. Importing this package imports nothing of the port."""
