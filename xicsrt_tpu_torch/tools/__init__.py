"""Measurement tools of the port: the roofline (``python -m
xicsrt_tpu_torch.tools.roofline``) and the scenario configurations it
measures (:mod:`xicsrt_tpu_torch.tools.bench_scenarios`)."""
