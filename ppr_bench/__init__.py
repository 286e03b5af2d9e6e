"""The benchmark of ``approximated_personalized_pagerank_tpu_torch`` on one
NVIDIA H100: ``python3 ppr_bench/run.py --workload <cell> ...`` (README.md)."""
