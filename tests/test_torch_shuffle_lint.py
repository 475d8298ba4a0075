"""The robustness lint of ``tests/lint_robustness.py`` over the port's
host shuffle.

Its first three rules, over every source of
``spark_rapids_tpu_torch/shuffle/`` and ``utils/queues.py`` (the JAX
package's lint does not cover the port):

1. no silent swallow: an ``except Exception`` (or bare ``except``) whose
   body does nothing;
2. a file that calls ``recv`` sets socket timeouts;
3. every blocking queue ``get`` is bounded (a timeout, or non-blocking).

Plus every ``join()`` of a thread or process carries a timeout.  A hang
in the shuffle costs every later run its whole time limit, and this
sandbox has no per-test timeout.
"""

import ast
import os

import pytest

from tests.lint_robustness import _call_has_timeout, _is_silent_swallow, \
    _queueish_receiver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "spark_rapids_tpu_torch")


def _sources():
    out = [os.path.join(PKG, "utils", "queues.py")]
    shuffle = os.path.join(PKG, "shuffle")
    out += sorted(os.path.join(shuffle, f) for f in os.listdir(shuffle)
                  if f.endswith(".py"))
    return out


SOURCES = _sources()
IDS = [os.path.relpath(p, REPO) for p in SOURCES]


def _tree(path):
    with open(path, encoding="utf-8") as f:
        return ast.parse(f.read(), filename=path)


def test_the_lint_covers_the_shuffle():
    names = {os.path.basename(p) for p in SOURCES}
    assert {"transport.py", "serializer.py", "manager.py", "stage.py",
            "worker.py", "queues.py"} <= names


@pytest.mark.parametrize("path", SOURCES, ids=IDS)
def test_no_silent_exception_swallows(path):
    offenders = [n.lineno for n in ast.walk(_tree(path))
                 if isinstance(n, ast.ExceptHandler)
                 and _is_silent_swallow(n)]
    assert not offenders, f"{path}: silent swallows at {offenders}"


@pytest.mark.parametrize("path", SOURCES, ids=IDS)
def test_recv_loops_are_bounded(path):
    with open(path, encoding="utf-8") as f:
        src = f.read()
    if ".recv(" in src or ".recv_into(" in src:
        assert "settimeout" in src, f"{path} reads sockets with no timeout"


@pytest.mark.parametrize("path", SOURCES, ids=IDS)
def test_blocking_queue_gets_are_bounded(path):
    offenders = [n.lineno for n in ast.walk(_tree(path))
                 if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Attribute)
                 and n.func.attr == "get" and _queueish_receiver(n.func)
                 and not _call_has_timeout(n)]
    assert not offenders, f"{path}: unbounded queue gets at {offenders}"


@pytest.mark.parametrize("path", SOURCES, ids=IDS)
def test_joins_are_bounded(path):
    offenders = [n.lineno for n in ast.walk(_tree(path))
                 if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Attribute)
                 and n.func.attr == "join" and not n.args
                 and not n.keywords]
    assert not offenders, f"{path}: unbounded joins at {offenders}"
