"""Observability: the process-wide histograms and stats snapshot
(``registry.py``; ``python -m spark_rapids_tpu_torch.obs`` prints it in
Prometheus exposition format), the JSONL event journal (``journal.py``)
and the query profile (``profile.py``: ``df.explain(analyze=True)``,
``session.last_query_profile()``).

Counterpart of ``spark_rapids_tpu/obs/``.
"""
