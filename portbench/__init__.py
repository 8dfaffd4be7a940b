"""The benchmark of the PyTorch/CUDA port (`indirect_learning_pose_shape_tpu_torch`)
on one NVIDIA H100: `python3 -m portbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>` runs one cell of `BENCHMARK.json` once.

Layout (each part found by its name, `spec.py`): `configs/` the model
configurations, `traffic/` the mixes, `drivers/` one module a way of driving
the port, `metrics/` one reader a per-layer metric, `limits/` the output
check's limits a cell; the yardstick beside them: `inputs.py` (stand-in,
weights, crops), `traffic.py` (the request generator), `trace.py` (profiler
reduction), `work/` (FLOPs, raster work, the card's peaks), `reference/` (the
plain reference), `compare.py` (the compared numbers); `control.py` reads
the limits' control on the card.
"""
