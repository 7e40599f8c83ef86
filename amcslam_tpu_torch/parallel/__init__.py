"""Multi-device solvers: landmark-sharded BA and edge-sharded essential graph.

Counterpart of `amcslam_tpu/parallel/`. The reference runs each sharded
solver as one SPMD program over a `jax.sharding.Mesh`; here each shard is a
process (a rank of `torch.distributed`, started by `group.run_ranks`) that
runs the single-device closures on its block and sums pose-level results
with `all_reduce`.
"""
