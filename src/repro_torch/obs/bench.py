"""The BENCH_*.json perf-trajectory format (counterpart of
``repro/obs/bench.py``, copied: it imports no JAX).

A benchmark publishes its headline rows as a small, stable JSON document
(``BENCH_<name>.json``): same schema, same row names, diffable numbers.
The port writes none yet; it keeps the format so that its documents
validate against the reference's.

Schema (version 1):

  {"bench": "executor", "schema_version": 1, "unit": "us_per_call",
   "config": {"quick": true, ...},
   "rows": [{"name": "exec_vmap_S4", "us_per_call": 1234.5,
             "derived": {"loss": 0.9876}}, ...]}

Rows mirror the CSV lines the benchmark already prints — ``name`` is the
stable join key across PRs; ``derived`` holds the per-row scalars (typed,
not the string blob the CSV carries).
"""
from __future__ import annotations

import json
import os

BENCH_SCHEMA_VERSION = 1
_SCALAR = (bool, int, float, str, type(None))


def make_bench(bench: str, rows: list, *, config: dict = None) -> dict:
    doc = {"bench": str(bench), "schema_version": BENCH_SCHEMA_VERSION,
           "unit": "us_per_call", "config": dict(config or {}),
           "rows": [dict(r) for r in rows]}
    validate_bench(doc)
    return doc


def validate_bench(doc: dict) -> None:
    """Raise ``ValueError`` unless ``doc`` is a valid BENCH document."""
    if not isinstance(doc, dict):
        raise ValueError(f"BENCH doc must be a dict, got {type(doc)}")
    for key in ("bench", "schema_version", "unit", "config", "rows"):
        if key not in doc:
            raise ValueError(f"BENCH doc missing {key!r}")
    if doc["schema_version"] != BENCH_SCHEMA_VERSION:
        raise ValueError(
            f"BENCH schema_version {doc['schema_version']!r} != "
            f"{BENCH_SCHEMA_VERSION}")
    if not isinstance(doc["rows"], list) or not doc["rows"]:
        raise ValueError("BENCH rows must be a non-empty list")
    seen = set()
    for row in doc["rows"]:
        if not isinstance(row, dict) or "name" not in row \
                or "us_per_call" not in row:
            raise ValueError(f"BENCH row needs name + us_per_call: {row}")
        if not isinstance(row["name"], str):
            raise ValueError(f"BENCH row name must be a str: {row}")
        if row["name"] in seen:
            raise ValueError(f"duplicate BENCH row name {row['name']!r}")
        seen.add(row["name"])
        if not isinstance(row["us_per_call"], (int, float)) \
                or isinstance(row["us_per_call"], bool):
            raise ValueError(f"BENCH us_per_call must be numeric: {row}")
        for k, v in row.get("derived", {}).items():
            if not isinstance(v, _SCALAR):
                raise ValueError(
                    f"BENCH derived[{k!r}] must be a JSON scalar, "
                    f"got {type(v).__name__}")


def write_bench(path: str, bench: str, rows: list, *,
                config: dict = None) -> dict:
    doc = make_bench(bench, rows, config=config)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return doc


def read_bench(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    validate_bench(doc)
    return doc
