"""Benchmark corpora of the port: data generators from numpy and the
queries, written against the port's DataFrame API."""
