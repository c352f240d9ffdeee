"""One driver a kind of traffic: ``perfbench/traffic/<mix>.json`` names its
driver under ``entry``, and ``run.py`` imports ``perfbench.entries.<entry>``
and calls its ``run(ctx)``."""
