"""`repro_torch.sim`: the trace-driven allocator simulator (port of
:mod:`repro.sim`), the paper's own evaluation: Table 3's speedups and the
Fig. 8-17 decompositions.

- :mod:`.workloads`  -- the paper's benchmarks as trace generators (a copy)
- :mod:`.policies`   -- the allocator policy models (a copy) and the
  prefix-cache eviction replay
- :mod:`.engine`     -- the trace scan (the ``sim_trace`` CUDA kernel on
  the card, its plain version on the CPU) and the per-cell metrics
- :mod:`.costmodel`, :mod:`.cachemodel` -- the cycle and cache-pollution
  formulas, on the host in float32
"""
