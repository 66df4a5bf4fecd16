"""The benchmark harness of the port: one cell of ``BENCHMARK.json`` run
once (``cell.run``), driven by the files that ``spec`` finds by name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py``, ``limits/<cell>.json`` and
``roofline/<config>.json``."""
