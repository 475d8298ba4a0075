"""Observability: the process-wide histograms and stats snapshot
(``registry.py``) and the JSONL event journal (``journal.py``).

Counterpart of ``spark_rapids_tpu/obs/``; the query profile
(``profile.py``) and the exporter's command line (``__main__.py``) wait
for a later slice (``ROADMAP.md``).
"""
