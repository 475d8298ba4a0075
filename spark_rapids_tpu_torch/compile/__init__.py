"""The compile store over the port's kernel libraries.

Counterpart of ``spark_rapids_tpu/compile/``, where it has a torch
analog.  The JAX package compiles every stage through XLA and keeps the
executables across processes; the port runs its stages eagerly and
compiles one thing, ``native.py``'s nvcc build of each hand kernel.  So:

* ``buckets``: the power-of-two capacity ladder every batch capacity
  routes through (``columnar/column.py: bucket_capacity``), with the
  ``spark.rapids.sql.compile.buckets.{minRows,maxRows}`` bounds, and the
  coalesce's row target snapped onto it;
* ``store``: the kernel libraries kept under
  ``<spark.rapids.sql.compile.cacheDir>/cuda/`` with an ``index.jsonl``
  of builds, shared by the processes that name the directory: a
  recorded library is loaded, never built again
  (``compileStoreHits``/``compileStoreMisses``, the ``compile.store``
  fault site);
* ``warm``: at runtime or server start, every kernel built or loaded and
  launched once on a tiny input on a supervised ``srt-compile-warm``
  thread;
* ``service``: the stats, nvcc build ms (``cold_ms``) against library
  load ms (``store_hit_ms``).

Not carried over, because each compiles or indexes stages, which the
port runs eagerly: ``engine_jit``, ``aot_compile``, the XLA persistent
cache and the store's (stage fingerprint, signature, capacity) index
with its pickled payloads (``ROADMAP.md``).

Off by default: with no ``spark.rapids.sql.compile.*`` key in a conf,
``configure_from_conf`` changes nothing.
"""


def configure_from_conf(conf, device=None, start_warm: bool = True) -> None:
    """The hook every seam calls (runtime start, query scope, server
    start): applies the ladder bounds and installs the store when the
    conf carries a ``spark.rapids.sql.compile.*`` key (a conf with none
    leaves another session's store alone), then starts the warm pool
    for ``device``."""
    from spark_rapids_tpu_torch.compile import buckets, store, warm
    from spark_rapids_tpu_torch.conf import COMPILE_PREFIX
    if not any(k.startswith(COMPILE_PREFIX) for k in conf.to_dict()):
        return
    buckets.configure_from_conf(conf)
    store.configure_from_conf(conf)
    if start_warm:
        warm.start_if_configured(conf, device)
