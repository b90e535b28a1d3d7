"""Distributed execution over a device mesh, single-controller.

The port of pg_strom_tpu/parallel: tables hash-partitioned across the
mesh's shards, all-to-all shuffles for join/group-by exchanges,
skew-aware routing and the DISTINCT dedup exchange.  One process plans
the query and drives every shard, as the reference's one `shard_map`
step does (mesh.py): a shard is a position of the mesh with its
torch.device, and the collectives move blocks between shards.
"""
