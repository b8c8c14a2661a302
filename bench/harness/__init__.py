"""The benchmark harness of ``repro_torch``: general code that every cell shares.

A cell is one entry of ``workloads`` in ``BENCHMARK.json``.  What belongs to
one configuration, one cell or one per-layer metric lives in files of its
own that the harness finds by name (:mod:`harness.manifest`):
``configs/<config>.json``, ``workloads/<cell>.json`` and
``metrics/<metric>.py``.  The program under test, ``repro_torch``, is
imported only by the runners (:mod:`harness.train`, :mod:`harness.serve`);
the plain references under ``reference/`` import nothing of it.
"""
