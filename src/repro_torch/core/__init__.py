"""The paper-reproduction core (counterpart of ``repro.core``): gradient
compression (``compression``), the survey's allreduce schedules on
``torch.distributed`` (``collectives``), the consistency spectrum
(``consistency``), model consolidation (``consolidation``) and
meta-optimization (``metaopt``), and the copies of the survey's Work-Depth
(``workdepth``) and cost models (``costmodel``)."""
