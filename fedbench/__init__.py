"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of FedPAC.

One command runs one cell once::

    python fedbench/run.py --workload vit_tiny.fedpac_soap.c20 \
        --seed 7 --seconds 50 --trace 0

A cell is a configuration (``configs/<name>.json``: the model and its data)
under a traffic mix (``traffic/<name>.json``: the algorithm and the
federation); ``cells/<workload>.json`` holds the cell's correctness limits.
A per-layer metric is a reader of its own (``metrics/<name>.py``).  The
harness finds every one of them by the name in ``BENCHMARK.json``, so a new
cell, configuration or metric is new files and entries only.

``reference/`` is the plain PyTorch reference that decides ``correct``: it
imports nothing of the program.  ``families/`` builds the program's
scenario for a configuration's model family.
"""
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
