"""Device operators.  The grouped pre-aggregation path: ops/preagg.py
(strategies and host finalization), ops/preagg_mxu.py (the column-sum
contract), ops/hashing.py, ops/sort.py (argsort_i32); scans
(ops/filter.py) and joins (ops/hashjoin.py, ops/joinagg.py); and the
kernels K1 (ops/preagg_fused2.py), K2 (ops/preagg_fused.py), K3
(ops/mxu_lookup.py) and K4 (ops/preagg_pallas.py), written by hand in
CUDA under ops/cuda/."""
