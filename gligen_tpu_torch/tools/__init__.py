"""Measurement tools of the port, each also a script: ``perf_probe.py``
(requests, train steps and each fused kernel against its module chain),
``bench_proj.py`` (the projection budget: K2, K7, cuBLAS and the bound),
``bench_block.py`` (one ds1 transformer block) and ``bench_resblock.py``
(ds1 ResBlocks)."""
