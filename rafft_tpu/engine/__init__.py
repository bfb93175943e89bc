"""Folding engines.

  fold_cpu — sequential engine, bit-exact mirror of the reference
             behaviour (beam BFS over helix formation); the parity oracle.
  fold_jax — batched fixed-shape device engine (jit/vmap/shard_map), the
             performance path.
"""
