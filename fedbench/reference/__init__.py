"""The plain reference of the benchmark: the federated round in plain
PyTorch, float32, computed from the inputs the benchmark made.

Nothing here imports the program (``repro_torch``), the JAX package or JAX:
the reference follows the published algorithms (FedPAC, SOAP, Muon) and
model descriptions, and the program is judged against it.  ``lowp=True``
runs every matrix product on TF32-rounded operands: the control, one
precision below the configuration's float32.
"""
