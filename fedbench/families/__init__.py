"""Program side of a configuration's model family: ``scenario(cfg,
traffic, seeds, device)`` registers the family's backbone with the
program's public hooks, on the benchmark's weights, and materializes the
program's scenario for it.  A configuration names its family
(``"family"``), which is also the name of its plain reference in
``fedbench/reference/``."""
