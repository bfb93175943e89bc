"""Scale-out: device meshes and data-parallel benchmark sweeps.

The fold workload is embarrassingly parallel across sequences (the
reference fans out one subprocess per sequence via multiprocessing.Pool,
in its benchmark_results/bench_fft.py:17-21).  The device
equivalent shards the batch axis of the fold engine across a
('data',)-axis device mesh: no collectives are needed in the fold inner
loop, so the cards of a host, and hosts (multi-controller
jax.distributed), each fold their own share of the batch.
"""
