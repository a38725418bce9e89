"""The multichip tier (``sharding.py``): a ('batch', 'graph') mesh of
shards that one process drives, on logical shards of one card or on
several cards (NCCL combines across them), its single-vantage and
incremental SSSP, and the whole-fabric step on a mesh or one card."""
