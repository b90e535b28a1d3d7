"""Device operators.  This slice ports the grouped pre-aggregation path:
ops/preagg.py (host half), ops/preagg_mxu.py (host half) and
ops/preagg_fused2.py, whose kernel is hand-written CUDA in ops/cuda/."""
